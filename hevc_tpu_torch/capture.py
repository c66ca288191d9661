"""Captures of what the frame program hands its stages, and replays of it,
for the checks and timings of ``chip_smoke.py``.

``Capture`` records, over a whole decode, the inputs of the kernel
wrappers (MC, residual add, intra wavefront, the loop filters) and the
SHVC upsampler and times every stage with the card synchronised;
``StageInputs`` records the inputs of each stage of one ``frame_program``
call, so that each stage can be timed alone; ``kernel_errors`` holds both
inter kernels against their plain versions on captured inputs,
``loop_filter_errors`` the loop filter kernels and ``residual_errors``
the residual kernel (on ``captured_residuals``' inputs).
``capture_frame_program`` keeps a stream's last P picture's frame program
call, ``Replay`` replays it (every replay equal to the decode; timed, or
traced by ``torch.profiler`` and read by ``busy_ms``), and
``stage_timings`` times each of its six stages alone, each a hand kernel
on the card: the residual transform, MC, the residual add, the intra
wavefront, deblocking and SAO.  ``pipeline.py`` imports the stage
functions by name, so they are patched in its namespace.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import numpy as np
import torch

from . import filters_cuda, mc_cuda, pipeline, upsample
from .bounds import bound_ms, stage_b_work
from .device import cuda_ms
from .mc import mc_plain, resid_add_plain
from .tables import tables_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# where ``Replay.profiled`` writes its trace
CACHE = os.path.join(ROOT, ".bench")
# the kinds of device activity in a torch.profiler trace that keep the
# card busy
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernel_us name of each stage ``StageInputs`` records, and of its
# term in ``stage_b_work``
STAGE_KEYS = {"residuals": "dequant_idct", "mc": "mc",
              "resid_add": "resid_add",
              "reconstruct_wavefront": "intra_wavefront",
              "intra": "intra_wavefront", "deblock_planes": "deblock",
              "deblock": "deblock", "sao_planes": "sao", "sao": "sao"}


class Capture:
    """On an uncounted decode: records the inputs the frame program
    hands each kernel wrapper (and the picture, (layer, POC), each came
    from; the intra wavefront's canvas copied before the kernel writes it
    in place, its counts as host arrays; the loop filters' planes copied,
    each picture's deblocking and SAO call in ``filters``, a dict with
    its ``at``, its picture's ``kind`` (``I``, ``P`` or ``B``) and each
    call's (args, kwargs)) and the SHVC upsampler's inputs
    and outputs, and times each stage of the frame program and of the
    inter-layer build with the device synchronised before and after (ms
    per call)."""

    STAGES = ("frame_program", "residuals", "reconstruct_wavefront",
              "deblock_planes", "sao_planes")
    # the inter-layer reference's steps: (module, function, stage name)
    IL = (("upsample", "color_map_frame", "il_color_map"),
          ("upsample", "upsample_frame", "il_upsample"),
          ("pipeline", "pad_dev_refs", "il_pad"))

    def __init__(self):
        self.mc, self.resid, self.mc_at, self.resid_at = [], [], [], []
        self.intra, self.intra_at = [], []
        self.filters = []
        self.upsample = []
        self.at = None
        self.ms = {k: [] for k in self.STAGES + ("mc", "resid_add")
                   + tuple(k for _m, _f, k in self.IL)}

    @contextlib.contextmanager
    def installed(self):
        mods = {"pipeline": pipeline, "upsample": upsample}
        orig = {k: getattr(pipeline, k) for k in self.STAGES}
        orig_il = {k: getattr(mods[m], f) for m, f, k in self.IL}
        orig_mc, orig_ra = mc_cuda.mc, mc_cuda.resid_add
        orig_finish = pipeline.finish_frame

        def timed(fn, name):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        mc_t, ra_t = timed(orig_mc, "mc"), timed(orig_ra, "resid_add")

        def mc(canvas, refs_l, refs_c, groups, bd):
            self.mc.append((canvas.clone(), refs_l.clone(), refs_c.clone(),
                            [g[:6] + (np.array(g[6]),) for g in groups], bd))
            self.mc_at.append(self.at)
            return mc_t(canvas, refs_l, refs_c, groups, bd)

        def resid_add(canvas, fields, pools, bd):
            self.resid.append((canvas.clone(), [f.clone() for f in fields],
                               [p.clone() for p in pools], bd))
            self.resid_at.append(self.at)
            return ra_t(canvas, fields, pools, bd)

        def finish(pic, lay, poc, device):
            self.at = (lay.layer_id, poc)
            kind = ("B" if getattr(pic, "ref_list_l1", None) else
                    "P" if getattr(pic, "ref_list_l0", None) else "I")
            self.filters.append({"at": self.at, "kind": kind})
            return orig_finish(pic, lay, poc, device)

        up_t = timed(orig_il["il_upsample"], "il_upsample")

        def upsample_frame(planes, *a, **k):
            out = up_t(planes, *a, **k)
            self.upsample.append(([p.clone() for p in planes], a, k,
                                  [p.clone() for p in out]))
            return out

        intra_t = timed(orig["reconstruct_wavefront"],
                        "reconstruct_wavefront")

        def reconstruct_wavefront(canvas, scal, avail, resids, bd, tables,
                                  counts=None):
            self.intra.append(intra_args(canvas, scal, avail, resids, bd,
                                         counts))
            self.intra_at.append(self.at)
            return intra_t(canvas, scal, avail, resids, bd, tables, counts)

        def filter_stage(name):
            run = timed(orig[name], name)

            def stage(planes, *a, **k):
                self.filters[-1][name] = (([p.clone() for p in planes],) + a,
                                          k)
                return run(planes, *a, **k)
            return stage

        mc_cuda.mc, mc_cuda.resid_add = mc, resid_add
        pipeline.finish_frame = finish
        for k, fn in orig.items():
            setattr(pipeline, k, timed(fn, k))
        pipeline.reconstruct_wavefront = reconstruct_wavefront
        pipeline.deblock_planes = filter_stage("deblock_planes")
        pipeline.sao_planes = filter_stage("sao_planes")
        for m, f, k in self.IL:
            setattr(mods[m], f, upsample_frame if k == "il_upsample"
                    else timed(orig_il[k], k))
        try:
            yield self
        finally:
            mc_cuda.mc, mc_cuda.resid_add = orig_mc, orig_ra
            pipeline.finish_frame = orig_finish
            for k, fn in orig.items():
                setattr(pipeline, k, fn)
            for m, f, k in self.IL:
                setattr(mods[m], f, orig_il[k])

    def report(self):
        return "; ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in v)
                         for k, v in self.ms.items() if v)


def intra_args(canvas, scal, avail, resids, bd, counts):
    """One intra wavefront call's inputs as a capture keeps them: the
    canvas copied before the kernel writes it in place, the counts as host
    arrays; the records, masks and pools, which nothing writes, as they
    are."""
    return (canvas.clone(), scal, avail, resids, bd,
            [np.array(c) for c in counts])


def _clone(x):
    """x with every tensor and NumPy array in it copied (lists and tuples
    rebuilt): the stage inputs outlive the buffers the frame program
    reuses or mutates."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class StageInputs:
    """During one ``frame_program`` call: the first call of each stage,
    as {stage: (function, args, kwargs)} with the inputs copied before the
    stage ran (MC and the residual add write their canvas in place).
    The loop filters' stages take every plane of the picture."""

    # (module, function) of each stage, in the frame program's order
    STAGES = ((pipeline, "residuals"), (mc_cuda, "mc"),
              (mc_cuda, "resid_add"), (pipeline, "reconstruct_wavefront"),
              (pipeline, "deblock_planes"), (pipeline, "sao_planes"))

    def __init__(self):
        self.calls = {}

    @contextlib.contextmanager
    def installed(self):
        orig = [(mod, name, getattr(mod, name)) for mod, name in self.STAGES]

        def recorded(fn, name):
            def run(*a, **k):
                if name not in self.calls:
                    self.calls[name] = (fn, _clone(a), _clone(k))
                return fn(*a, **k)
            return run

        for mod, name, fn in orig:
            setattr(mod, name, recorded(fn, name))
        try:
            yield self
        finally:
            for mod, name, fn in orig:
                setattr(mod, name, fn)


def mc_error(mc_args):
    """The largest |kernel - plain| of MC on one picture's (or band's)
    captured wrapper inputs, on their card."""
    canvas, refs_l, refs_c, groups, bd = mc_args
    table = mc_cuda.mc_table(groups, canvas.shape)
    rows = torch.from_numpy(table.rows).to(canvas.device).int()
    got = mc_cuda.mc(canvas.clone(), refs_l, refs_c, groups, bd)
    want = mc_plain(canvas.clone(), refs_l, refs_c,
                    mc_cuda.table_groups(table, rows), bd,
                    tables_from_reference(canvas.device))
    return int((got - want).abs().max())


def resid_add_error(resid_args):
    """The largest |kernel - plain| of the residual add on one picture's
    (or band's) captured wrapper inputs, on their card."""
    canvas, fields, pools, bd = resid_args
    got = mc_cuda.resid_add(canvas.clone(), fields, pools, bd)
    want = resid_add_plain(canvas.clone(), fields, pools, bd)
    return int((got - want).abs().max())


def kernel_errors(mc_args, resid_args):
    """(mc_err, resid_add_err): each inter kernel against its plain version
    on one picture's (or band's) captured wrapper inputs, on their card."""
    return mc_error(mc_args), resid_add_error(resid_args)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def capture_frame_program(data, dev):
    """Decode ``data`` once (every MD5 checked) with
    ``pipeline.frame_program`` wrapped; returns (arguments, fused output)
    of the last P picture's call, its reference planes copied (the
    decoder's device DPB drops them later)."""
    from .decoder import TorchDecoder
    got = []
    orig = pipeline.frame_program

    def wrapper(*args):
        out = orig(*args)
        if args[7]:                       # refs_y: an inter picture
            refs = tuple([r.clone() for r in args[i]] for i in (7, 8, 9))
            got[:] = [(args[:7] + refs + args[10:], out[0].clone())]
        return out

    pipeline.frame_program = wrapper
    try:
        frames = TorchDecoder(check_md5=True, device=dev).decode_bytes(data)
        bad = [f.poc for f in frames if f.md5_ok is not True]
    finally:
        pipeline.frame_program = orig
    if bad:
        raise RuntimeError(f"capture: MD5 wrong on POCs {bad}")
    if not got:
        raise RuntimeError("capture: the stream has no P picture")
    return got[0]


def busy_ms(trace_path):
    """The union of the device activity intervals (kernels, copies, sets)
    in a ``torch.profiler`` chrome trace, in ms."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events
                if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not iv:
        raise RuntimeError(f"{trace_path}: no device activity in the trace")
    total, (lo, hi) = 0.0, iv[0]
    for a, b in iv[1:]:
        if a > hi:
            total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + hi - lo) / 1e3


class Replay:
    """A captured frame program call, replayed: every replay's fused
    output must equal the decode's, bit for bit."""

    def __init__(self, args, want, dev, name):
        self.args, self.want, self.dev, self.name = args, want, dev, name
        self.count = 0

    def run(self, iters):
        outs = [pipeline.frame_program(*self.args)[0] for _ in range(iters)]
        for k, out in enumerate(outs):
            if not torch.equal(out, self.want):
                raise RuntimeError(f"stage-B replay {self.count + k} of "
                                   f"{self.name} differs from the decode")
        self.count += iters
        return outs

    def timed(self, iters):
        """Replays a second of wall clock, card synchronised."""
        self.run(1)
        _sync(self.dev)
        t0 = time.perf_counter()
        self.run(iters)
        _sync(self.dev)
        return iters / (time.perf_counter() - t0)

    def profiled(self, iters):
        """(device-busy ms a replay, idle share) over ``iters`` replays
        traced by ``torch.profiler``: busy is the union of the device
        activity in the trace (``CACHE/trace_stageB_<name>.json``), idle
        1 - busy / the host's wall clock over the traced replays (card
        synchronised)."""
        from torch.profiler import ProfilerActivity, profile
        self.run(1)
        _sync(self.dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            self.run(iters)
            _sync(self.dev)
            wall = (time.perf_counter() - t0) * 1e3
        os.makedirs(CACHE, exist_ok=True)
        path = os.path.join(CACHE, f"trace_stageB_{self.name}.json")
        prof.export_chrome_trace(path)
        busy = busy_ms(path)
        return busy / iters, 1.0 - busy / wall


def stage_timings(path, dev, iters, name):
    """The last P picture's frame program of the stream at ``path``
    replayed ``iters`` times (replays a second, card synchronised; None on
    the CPU), then each stage alone on the inputs it had in one call (16
    calls between CUDA events) beside its bound from
    ``bounds.stage_b_work``; both inter kernels against their plain
    versions.  Returns (Replay, {key: value}), the keys of one stage
    ending in ``_<name>``.  ``Replay.profiled`` gives the device-busy time
    later, after every other timing (a profiler session slows the rest of
    the process)."""
    with open(path, "rb") as f:
        args, want = capture_frame_program(f.read(), dev)
    rep = Replay(args, want, dev, name)
    if dev.type == "cuda":
        fps = rep.timed(iters)
    else:
        rep.run(iters)
        fps = None
    rec = StageInputs()
    with rec.installed():
        flat = pipeline.frame_program(*args)[0]
    if not torch.equal(flat, rep.want):
        raise RuntimeError("stages: the recorded call differs from the "
                           "decode")
    calls = rec.calls
    if len({STAGE_KEYS[n] for n in calls}) != 6:
        raise RuntimeError(f"stages: the P picture ran only {sorted(calls)}")
    mc_err, ra_err = kernel_errors(calls["mc"][1], calls["resid_add"][1])
    if mc_err or ra_err:
        raise RuntimeError(f"stages: kernels != plain versions (mc "
                           f"{mc_err}, resid_add {ra_err})")
    stage_work = stage_b_work(args)
    work = {f"{STAGE_KEYS[n]}_{name}": stage_work[n] for n in (
        "residuals", "mc", "resid_add", "intra", "deblock", "sao")}
    y = calls["sao_planes"][1][0][0]
    bounds = {k: bound_ms(*v) for k, v in work.items()}
    out = {"kernel_max_abs_err": {"mc": mc_err, "resid_add": ra_err},
           "kernel_bytes": {k: v[0] for k, v in work.items()},
           "kernel_bound_us": {k: b[0] * 1e3 for k, b in bounds.items()},
           "kernel_bound_by": {k: b[1] for k, b in bounds.items()},
           f"stageB_replay_fps_{name}": fps,
           f"stageB_replays_{name}": rep.count,
           "kernel_us": None, "kernel_gbps": None}
    if dev.type == "cuda":
        us = {}
        for stage, (fn, a, k) in calls.items():
            if stage in ("mc", "resid_add", "reconstruct_wavefront"):
                # the kernels write their canvas in place
                a = (a[0].clone(),) + tuple(a[1:])
            if stage == "deblock_planes":
                # deblocking writes its planes in place: each timed call
                # filters a fresh copy of the recorded ones, less the copy
                src, planes = a[0], [p.clone() for p in a[0]]

                def fresh(src=src, planes=planes):
                    for t, p in zip(planes, src):
                        t.copy_(p)

                def run(fn=fn, planes=planes, a=a, k=k, fresh=fresh):
                    fresh()
                    fn(planes, *a[1:], **k)
                ms = cuda_ms(run, iters=16) - cuda_ms(fresh, iters=16)
            else:
                ms = cuda_ms(functools.partial(fn, *a, **k), iters=16)
            us[f"{STAGE_KEYS[stage]}_{name}"] = ms * 1e3
        ew = cuda_ms(lambda: y + 1, iters=16) * 1e3
        gbps = {"roofline_elementwise": y.numel() * 4 * 2 / 1e6 / (ew / 1e3)}
        for k, v in work.items():
            gbps[k] = v[0] / 1e3 / us[k]
        out["kernel_us"], out["kernel_gbps"] = us, gbps
    return rep, out


def loop_filter_errors(call):
    """{stage: largest |kernel - plain|} of one picture's captured loop
    filter calls (``Capture.filters``' dict), each wrapper against its
    plain version on copies of the captured planes, on their card."""
    plain = {"deblock_planes": filters_cuda.deblock_plain,
             "sao_planes": filters_cuda.sao_plain}
    errs = {}
    for name, ref in plain.items():
        if name not in call:
            continue
        (planes, *a), k = call[name]
        got = getattr(filters_cuda, name)([p.clone() for p in planes], *a,
                                          **k)
        want = ref([p.clone() for p in planes], *a, **k)
        errs[name] = max(int((g - w).abs().max()) for g, w in zip(got, want))
    return errs


def bank_prefix(bank_dir, n):
    """The first ``n`` access units of the first segment of a benchmark
    bank (``benchmark/data/<config>/<traffic>``, whose ``bank.json`` lists
    each segment's access-unit sizes), as one Annex-B stream."""
    with open(os.path.join(bank_dir, "bank.json")) as f:
        seg = json.load(f)["segments"][0]
    with open(os.path.join(bank_dir, seg["file"]), "rb") as f:
        data = f.read()
    return data[:sum(seg["au_sizes"][:n])]


def captured_filters(data, dev):
    """``Capture.filters`` of one decode of ``data`` on ``dev``: each
    picture's loop filter calls, its (layer, POC) and its kind."""
    from .decoder import TorchDecoder
    cap = Capture()
    with cap.installed():
        TorchDecoder(device=dev).decode_bytes(data)
    return cap.filters


def captured_residuals(data, dev):
    """Each picture's residual-stage inputs over one decode of ``data`` on
    ``dev``: dicts with the picture's ``at`` ((layer, POC)), ``kind`` and
    ``args``, the (levels, rmeta, bit depth, scaling banks) the frame
    program handed ``residuals`` (nothing writes them).  Needs no card."""
    from .decoder import TorchDecoder
    calls, now = [], {}
    orig_res, orig_finish = pipeline.residuals, pipeline.finish_frame

    def finish(pic, lay, poc, device):
        now["at"] = (lay.layer_id, poc)
        now["kind"] = ("B" if getattr(pic, "ref_list_l1", None) else
                       "P" if getattr(pic, "ref_list_l0", None) else "I")
        return orig_finish(pic, lay, poc, device)

    def residuals(levels, rmeta, bd, bank, tables):
        calls.append({"at": now["at"], "kind": now["kind"],
                      "args": (levels, rmeta, bd, bank)})
        return orig_res(levels, rmeta, bd, bank, tables)

    pipeline.finish_frame, pipeline.residuals = finish, residuals
    try:
        TorchDecoder(device=dev).decode_bytes(data)
    finally:
        pipeline.finish_frame, pipeline.residuals = orig_finish, orig_res
    return calls


def residual_errors(args):
    """(largest |kernel - plain| over the four pools, launches): one
    picture's captured residual inputs through ``resid_cuda.residuals`` and
    its plain version, on their card."""
    from . import build, resid_cuda
    levels, rmeta, bd, bank = args
    tables = tables_from_reference(rmeta[0].device)
    before = build.launches["resid_tx"]
    got = resid_cuda.residuals(levels, rmeta, bd, bank, tables)
    launches = build.launches["resid_tx"] - before
    want = resid_cuda.residuals_plain(levels, rmeta, bd, bank, tables)
    return max(int((g - w).abs().max()) for g, w in zip(got, want)), launches


def pick_picture(calls, kind):
    """The first captured picture of ``kind`` (``I``, ``P`` or ``B``; a B
    of odd POC, a leaf of a hierarchical GOP of 4)."""
    return next(c for c in calls if c["kind"] == kind
                and (kind != "B" or c["at"][1] % 2))
