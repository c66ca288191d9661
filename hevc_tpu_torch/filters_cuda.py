"""Wrapper of the in-loop filter kernels in ``csrc/filters.cu``.

``deblock_planes`` and ``sao_planes`` take one picture's planes (``[y]``
for 4:0:0, else ``[y, cb, cr]``) with the per-4x4 and per-CTB maps the
frame program unpacks.  For tensors on the CPU they run the plain versions
(``deblock_plain``, ``sao_plain``: ``filters.deblock`` / ``deblock_luma`` /
``sao_plane`` with the sample masks those take built from the per-4x4
``nf`` map); for CUDA tensors they check every tensor and launch the
kernels, and raise on any refusal: they never fall back.
``deblock_planes`` filters the planes in place on both devices (on the
card with two launches, vertical edges then horizontal edges), so a caller
never reads the picture before deblocking through them again;
``sao_planes`` writes new planes, views of one buffer, with one launch.  The kernels read the maps
where they lie and keep the filter tables as constants of their own, so
``tables`` is read only by the plain versions.  Each launch adds one to
``build.launches["deblock"]`` or ``["sao"]`` and to the trace's
``loop_filter_launches`` counter.
"""
from __future__ import annotations

import ctypes as C

import torch

from . import build, filters, trace


class FilterPlane(C.Structure):
    """``FilterPlane`` of ``csrc/filters.cu``, field for field."""
    _fields_ = [("src", C.c_void_p), ("dst", C.c_void_p),
                ("stride", C.c_int), ("dst_stride", C.c_int),
                ("h", C.c_int), ("w", C.c_int), ("sy", C.c_int),
                ("sx", C.c_int), ("lh", C.c_int), ("lw", C.c_int),
                ("qp_off", C.c_void_p), ("sao_type", C.c_void_p),
                ("sao_band", C.c_void_p), ("sao_eo", C.c_void_p),
                ("sao_offs", C.c_void_p)]


class FilterParams(C.Structure):
    """``FilterParams`` of ``csrc/filters.cu``, field for field."""
    _fields_ = [("pl", FilterPlane * 3), ("nplanes", C.c_int),
                ("bd", C.c_int), ("h4", C.c_int), ("w4", C.c_int),
                ("ctw", C.c_int), ("chroma_tab", C.c_int),
                ("beta_map", C.c_int), ("tc_map", C.c_int),
                ("qp4", C.c_void_p), ("bs_v", C.c_void_p),
                ("bs_h", C.c_void_p), ("beta_off", C.c_void_p),
                ("tc_off", C.c_void_p), ("nf4", C.c_void_p),
                ("sao_flags", C.c_void_p)]


def pixel_masks(nf4, shapes, sub_w, sub_h):
    """The plain versions' bool sample masks (luma's, chroma's) of the
    per-4x4 ``nf`` map, for planes of ``shapes``; (None, None) without a
    map."""
    if nf4 is None:
        return None, None
    nf_l = (nf4 != 0).repeat_interleave(4, 0).repeat_interleave(4, 1)
    (hl, wl), (hc, wc) = shapes[0], shapes[-1]
    return nf_l[:hl, :wl], nf_l[::sub_h, ::sub_w][:hc, :wc]


def _ctb_log2(ctb_log2, k, sub_w, sub_h):
    """(log2 height, log2 width) of a CTB in plane k's samples."""
    sub = (1, 1) if k == 0 else (sub_h, sub_w)
    return (ctb_log2 - sub[0].bit_length() + 1,
            ctb_log2 - sub[1].bit_length() + 1)


def _planes(p, planes, bd, sub_w, sub_h):
    """Fill ``p``'s planes; each a 2-D int32 tensor on the first one's
    device with unit column stride (rows may lie apart, as views of the
    canvas do).  Returns the device."""
    dev = planes[0].device
    if len(planes) not in (1, 3):
        raise ValueError(f"loop filter: {len(planes)} planes")
    if not 8 <= bd <= 16 or sub_w not in (1, 2) or sub_h not in (1, 2):
        raise ValueError(f"loop filter: bit depth {bd}, subsampling "
                         f"{sub_w}x{sub_h}")
    for k, t in enumerate(planes):
        if (t.device != dev or t.dtype != torch.int32 or t.dim() != 2
                or t.stride(1) != 1):
            raise ValueError(f"plane {k}: expected a 2-D int32 tensor on "
                             f"{dev} with unit column stride, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()} on "
                             f"{t.device}")
        q = p.pl[k]
        q.src = t.data_ptr()
        q.stride = t.stride(0)
        q.h, q.w = t.shape
        q.sy, q.sx = (0, 0) if k == 0 else (sub_h - 1, sub_w - 1)
    p.nplanes = len(planes)
    p.bd = bd
    return dev


def _map(name, t, shape, dev):
    build.check_tensor(name, t, len(shape), dev)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.data_ptr()


def _one(name, t, dev):
    """The address of one int32 on ``dev``."""
    build.check_tensor(name, t, t.dim(), dev)
    if t.numel() != 1:
        raise ValueError(f"{name}: one offset, got {tuple(t.shape)}")
    return t.data_ptr()


def _offset(name, off, shape, dev):
    """(address, is_map) of a beta/tc offset: a per-4x4 map or one int32."""
    if off.dim() == 2:
        return _map(name, off, shape, dev), 1
    return _one(name, off, dev), 0


def deblock_params(planes, qp4, bs_v4, bs_h4, beta_off, tc_off, qp_offs,
                   bd, sub_w, sub_h, nf4=None):
    """The launch's ``FilterParams``, after checking each tensor's device,
    type, shape and contiguity against the kernels' layout."""
    p = FilterParams()
    dev = _planes(p, planes, bd, sub_w, sub_h)
    h4, w4 = qp4.shape if qp4.dim() == 2 else (-1, -1)
    shape = (h4, w4)
    p.qp4 = _map("qp4", qp4, shape, dev)
    p.bs_v = _map("bs_v4", bs_v4, shape, dev)
    p.bs_h = _map("bs_h4", bs_h4, shape, dev)
    p.beta_off, p.beta_map = _offset("beta_off", beta_off, shape, dev)
    p.tc_off, p.tc_map = _offset("tc_off", tc_off, shape, dev)
    if nf4 is not None:
        p.nf4 = _map("nf4", nf4, shape, dev)
    for k in range(1, len(planes)):
        p.pl[k].qp_off = _one(f"qp_offs[{k - 1}]", qp_offs[k - 1], dev)
    for k in range(len(planes)):
        q = p.pl[k]
        if (q.h << q.sy) > 4 * h4 or (q.w << q.sx) > 4 * w4:
            raise ValueError(f"plane {k} ({q.h}x{q.w}) outruns the per-4x4 "
                             f"maps {tuple(qp4.shape)}")
    p.h4, p.w4 = h4, w4
    p.chroma_tab = int(sub_w == sub_h == 2)
    return p


def sao_params(planes, sao_t, sao_b, sao_o, sao_e, ctb_log2, bd, sub_w,
               sub_h, edge_flags=None, nf4=None):
    """``sao_planes``' ``FilterParams`` and its output planes (views of one
    new buffer), after the checks of ``deblock_params``."""
    p = FilterParams()
    dev = _planes(p, planes, bd, sub_w, sub_h)
    n = len(planes)
    cth, ctw = sao_t.shape[1:] if sao_t.dim() == 3 else (-1, -1)
    shape = (sao_t.shape[0], cth, ctw)
    if shape[0] < n:
        raise ValueError(f"sao maps of {shape[0]} planes for {n}")
    base = [_map("sao_t", sao_t, shape, dev), _map("sao_b", sao_b, shape, dev),
            _map("sao_e", sao_e, shape, dev),
            _map("sao_o", sao_o, shape + (4,), dev)]
    if edge_flags is not None:
        p.sao_flags = _map("edge_flags", edge_flags, (cth, ctw), dev)
    if nf4 is not None:
        if nf4.dim() != 2:
            raise ValueError(f"nf4: a per-4x4 map, got {tuple(nf4.shape)}")
        p.nf4 = _map("nf4", nf4, nf4.shape, dev)
        p.h4, p.w4 = nf4.shape
    total = sum(t.shape[0] * t.shape[1] for t in planes)
    flat = planes[0].new_empty(total)
    out, off = [], 0
    for k, t in enumerate(planes):
        q = p.pl[k]
        q.lh, q.lw = _ctb_log2(ctb_log2, k, sub_w, sub_h)
        if (q.h - 1) >> q.lh >= cth or (q.w - 1) >> q.lw >= ctw:
            raise ValueError(f"plane {k} ({q.h}x{q.w}) outruns the CTB maps "
                             f"{cth}x{ctw}")
        if nf4 is not None and ((q.h << q.sy) > 4 * p.h4
                                or (q.w << q.sx) > 4 * p.w4):
            raise ValueError(f"plane {k} ({q.h}x{q.w}) outruns the nf map "
                             f"{tuple(nf4.shape)}")
        o = flat[off:off + q.h * q.w].view(q.h, q.w)
        off += q.h * q.w
        q.dst, q.dst_stride = o.data_ptr(), q.w
        step = 4 * cth * ctw * k
        q.sao_type, q.sao_band, q.sao_eo = (b + step for b in base[:3])
        q.sao_offs = base[3] + 4 * step
        out.append(o)
    p.ctw = ctw
    return p, out


def _launch(name, fn, dev, params, n):
    """One launcher call on ``dev``'s current stream; ``n`` launches."""
    rc = build.launch(dev, fn, C.byref(params), build.stream(dev))
    build.raise_on(rc, f"{name}_kernel")
    build.launches[name] += n
    trace.count("loop_filter_launches", n)


def deblock_plain(planes, qp4, bs_v4, bs_h4, beta_off, tc_off, qp_offs,
                  tables, bd, sub_w, sub_h, nf4=None):
    """``deblock_planes``' plain version on any device: ``filters.deblock``
    (``deblock_luma`` for 4:0:0) with the sample masks of ``nf4``; returns
    new planes."""
    nf_y, nf_c = pixel_masks(nf4, [t.shape for t in planes], sub_w, sub_h)
    if len(planes) == 1:
        return [filters.deblock_luma(planes[0], qp4, bs_v4, bs_h4, beta_off,
                                     tc_off, tables, bd, nf_y)]
    return list(filters.deblock(
        *planes, qp4, bs_v4, bs_h4, beta_off, tc_off, *qp_offs, tables,
        bd=bd, sub_w=sub_w, sub_h=sub_h, nf_y=nf_y, nf_c=nf_c))


def deblock_planes(planes, qp4, bs_v4, bs_h4, beta_off, tc_off, qp_offs,
                   tables, bd, sub_w, sub_h, nf4=None):
    """Deblocking (8.7.2) of one picture's planes, in place on both
    devices: on the CPU ``deblock_plain``'s result copied into the planes,
    on the card two launches that filter them; returns the planes.

    qp4 / bs_v4 / bs_h4: int32 per-4x4 maps [h4, w4]; beta_off / tc_off:
    such maps or one offset each; qp_offs: the Cb and Cr QP offsets (on the
    card, every offset an int32 tensor); nf4: the per-4x4 map of samples
    exempt from the loop filters, or None."""
    if planes[0].device.type == "cpu":
        out = deblock_plain(planes, qp4, bs_v4, bs_h4, beta_off, tc_off,
                            qp_offs, tables, bd, sub_w, sub_h, nf4)
        for t, o in zip(planes, out):
            t.copy_(o)
        return planes
    params = deblock_params(planes, qp4, bs_v4, bs_h4, beta_off, tc_off,
                            qp_offs, bd, sub_w, sub_h, nf4)
    dev = planes[0].device
    _launch("deblock", build.load().hevc_deblock_launch, dev, params, 2)
    return planes


def sao_plain(planes, sao_t, sao_b, sao_o, sao_e, ctb_log2, bd, sub_w,
              sub_h, edge_flags=None, nf4=None):
    """``sao_planes``' plain version on any device: ``filters.sao_plane``
    a plane."""
    nf_y, nf_c = pixel_masks(nf4, [t.shape for t in planes], sub_w, sub_h)
    return [filters.sao_plane(
        t, sao_t[k], sao_b[k], sao_o[k], sao_e[k],
        _ctb_log2(ctb_log2, k, sub_w, sub_h), bd, edge_flags=edge_flags,
        nf=nf_y if k == 0 else nf_c) for k, t in enumerate(planes)]


def sao_planes(planes, sao_t, sao_b, sao_o, sao_e, ctb_log2, bd, sub_w,
               sub_h, edge_flags=None, nf4=None):
    """SAO (8.7.3) of one picture's planes into new planes: ``sao_plain`` on
    the CPU, one launch on the card.

    sao_t / sao_b / sao_e: int32 per-CTB type, band position and edge
    class [planes, cth, ctw]; sao_o: the offsets [planes, cth, ctw, 4];
    ctb_log2: the luma CTB's log2 size; edge_flags: the per-CTB
    ``ops.boundaries.SAO_*`` bits [cth, ctw] or None; nf4 as for
    ``deblock_planes``."""
    if planes[0].device.type == "cpu":
        return sao_plain(planes, sao_t, sao_b, sao_o, sao_e, ctb_log2, bd,
                         sub_w, sub_h, edge_flags, nf4)
    params, out = sao_params(planes, sao_t, sao_b, sao_o, sao_e, ctb_log2,
                             bd, sub_w, sub_h, edge_flags, nf4)
    _launch("sao", build.load().hevc_sao_launch, planes[0].device, params, 1)
    return out
