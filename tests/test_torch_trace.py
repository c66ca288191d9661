"""The port's tracing (``hevc_tpu_torch.trace``) on the CPU: span
accumulators, counters, the bounded timeline, per-picture chains of spans
through ``hevc_tpu_torch.api``, the shared clock with ``torch.profiler``,
the merged chrome trace and the ``h2d_bytes`` counter."""
import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hevc_tpu_torch import api, mc_cuda, native, pipeline, tables, trace
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.io.parser import split_access_units

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh():
    trace.timeline_stop()
    trace.reset()
    yield
    trace.timeline_stop()
    trace.reset()


def _aus(n=4):
    """Access units of a 96x64 IPP stream (deblocking, SAO)."""
    cfg = EncoderConfig(width=96, height=64, qp=30, log2_ctb_size=5,
                        log2_cu_size=5, seed=3, gop="ipp", search_range=2,
                        deblocking=True, sao=True)
    enc = IntraEncoder(cfg)
    stream = b"".join(enc.encode_frame(synth_frame("noise", 96, 64, t,
                                                   seed=6))
                      for t in range(n))
    return split_access_units(stream)


def _decode(aus, first_pts=0):
    """Decode through one API handle, the pts of unit k first_pts + k,
    draining with ``decode(None)``; every picture's planes fetched."""
    h = api.oh_init(device=CPU)
    h.start()
    got = []

    def grab(ret):
        ok, fr = ret
        if ok:
            got.append((fr.info.pts, [np.asarray(p).copy()
                                      for p in fr.planes]))
        return ok

    for k, au in enumerate(aus):
        grab(h.decode(au, pts=first_pts + k))
    while grab(h.decode(None)):
        pass
    h.close()
    return got


def test_existing_span_names_keep_their_accumulators():
    for _ in range(3):
        with trace.span("stage_a_native"):
            time.sleep(0.002)
    with trace.span("fetch"):
        pass
    rep = trace.report()
    assert set(rep["stage_a_native"]) == {"calls", "total_s", "self_s"}
    assert rep["stage_a_native"]["calls"] == 3
    assert 0.006 <= rep["stage_a_native"]["total_s"] < 1.0
    assert rep["fetch"]["calls"] == 1
    assert rep[trace.WALL]["total_s"] >= rep["stage_a_native"]["total_s"]
    trace.reset()
    assert set(trace.report()) == {trace.WALL}


def test_self_time_leaves_out_nested_spans_of_the_same_thread():
    def other():
        with trace.span("elsewhere"):
            time.sleep(0.02)

    with trace.span("outer"):
        t = threading.Thread(target=other)
        t.start()
        with trace.span("inner"):
            time.sleep(0.03)
        t.join(timeout=30)
        time.sleep(0.01)
    rep = trace.report()
    o, i = rep["outer"], rep["inner"]
    assert i["self_s"] == i["total_s"]
    assert o["self_s"] == pytest.approx(o["total_s"] - i["total_s"],
                                        abs=2e-6)
    assert o["self_s"] >= 0.01 and rep["elsewhere"]["total_s"] >= 0.02


def test_counters_report_a_total():
    trace.count("h2d_bytes", 100)
    trace.count("h2d_bytes", 28)
    trace.count("device_allocs", 0)
    rep = trace.report()
    assert rep["h2d_bytes"] == {"calls": 2, "total": 128}
    assert rep["device_allocs"] == {"calls": 1, "total": 0}
    assert not hasattr(trace, "add")


def test_accumulation_holds_under_threads():
    threads, per = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with trace.span("s"):
                    trace.count("c", 2)
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    rep = trace.report()
    assert rep["s"]["calls"] == threads * per
    assert rep["c"] == {"calls": threads * per, "total": 2 * threads * per}


def test_the_timeline_is_off_by_default():
    code = ("from hevc_tpu_torch import trace\n"
            "with trace.span('x'):\n"
            "    pass\n"
            "print(len(trace.timeline()), trace.current(), "
            "trace.report()['x']['calls'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.split() == ["0", "None", "1"]


def test_the_timeline_is_bounded_and_counts_its_drops():
    trace.timeline_start(capacity=10)
    for k in range(25):
        with trace.span(f"x{k}", pic=k):
            pass
    recs = trace.timeline_stop()
    assert [r.name for r in recs] == [f"x{k}" for k in range(15, 25)]
    assert trace.dropped() == 15
    assert all(r.start_ns <= r.end_ns for r in recs)
    with trace.span("after"):
        pass
    assert [r.name for r in trace.timeline()] == [r.name for r in recs]


def test_nested_spans_inherit_picture_and_parent():
    trace.timeline_start()
    with trace.span("outer", pic=7) as o:
        with trace.span("inner"):
            pass
        h = trace.handoff()
    recs = {r.name: r for r in trace.timeline_stop()}
    assert recs["inner"].pic == 7 and recs["inner"].parent == o.sid
    assert recs["outer"].parent is None
    assert (h.pic, h.parent) == (7, o.sid)


@pytest.mark.skipif(not native.available(),
                    reason="native toolchain unavailable")
def test_each_picture_has_one_chain_of_spans():
    aus = _aus(4)
    trace.timeline_start()
    got = _decode(aus, first_pts=100)
    recs = trace.timeline_stop()
    assert trace.dropped() == 0
    assert sorted(p for p, _ in got) == [100, 101, 102, 103]
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    for pic in range(100, 104):
        mine = [r for r in recs if r.pic == pic]
        (d,) = [r for r in mine if r.name == "device_dispatch"]
        w = by_id[d.parent]
        assert w.name == "pack_worker" and w.pic == pic
        assert w.thread != threading.main_thread().name
        submit = by_id[w.parent]
        assert submit.name == "api_decode"
        (q,) = [r for r in mine if r.name == "pack_queue"
                and r.parent == w.parent and r.tid == w.tid
                and abs(r.end_ns - w.start_ns) < 1_000_000]
        stage_a = [r for r in mine if r.name.startswith("stage_a_")]
        assert stage_a
        for s in stage_a:
            caller = by_id[s.parent]
            assert caller.name == "api_decode" and caller.pic == pic
            assert s.end_ns <= q.start_ns
        assert q.end_ns <= w.start_ns <= d.start_ns <= d.end_ns <= w.end_ns
        stages = [r for r in recs if r.parent == d.id]
        assert {r.name for r in stages} >= {
            "dispatch.upload", "dispatch.residuals", "dispatch.mc",
            "dispatch.intra", "dispatch.deblock", "dispatch.sao",
            "dispatch.output"}
        assert all(r.pic == pic for r in stages)
        (f,) = [r for r in mine if r.name == "fetch"]
        assert f.parent == w.id and w.end_ns <= f.start_ns
        for o in [r for r in mine if r.name == "output_wait"]:
            assert o.parent == w.id and o.end_ns <= f.start_ns
            assert o.tid == f.tid
    rep = trace.report()
    assert rep["api_decode"]["calls"] >= 4
    assert rep["pack_worker"]["calls"] == rep["pack_queue"]["calls"]


def test_a_main_thread_span_shares_the_profiler_clock(tmp_path):
    trace.timeline_start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe_span", pic=3):
            torch.ones(64).sum()
            time.sleep(0.005)
    (rec,) = trace.timeline_stop()
    path = str(tmp_path / "p.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    (ev,) = [e for e in doc["traceEvents"] if e.get("name") == "probe_span"
             and e.get("ph") == "X"]
    assert ev["cat"] == "user_annotation"
    assert rec.profiled
    start = base + ev["ts"] * 1e3
    end = start + ev["dur"] * 1e3
    assert abs(start - rec.start_ns) < 1e6
    assert abs(end - rec.end_ns) < 1e6


def test_export_puts_a_worker_span_on_its_own_tid(tmp_path):
    trace.timeline_start()
    seen = {}

    def worker():
        seen["tid"] = threading.get_native_id()
        with trace.span("worker_span", pic=5):
            torch.zeros(32).add_(1)
            time.sleep(0.003)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("caller_span", pic=5):
            t = threading.Thread(target=worker, name="pack-like")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    trace.timeline_stop()
    raw = str(tmp_path / "raw.json")
    prof.export_chrome_trace(raw)
    merged = str(tmp_path / "merged.json")
    trace.export_chrome(merged, raw)
    with open(merged) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    (w,) = [e for e in spans if e["name"] == "worker_span"]
    (c,) = [e for e in spans if e["name"] == "caller_span"]
    assert w["tid"] == seen["tid"] != c["tid"]
    assert w["args"]["pic"] == 5
    assert c["ts"] <= w["ts"] and w["ts"] + w["dur"] <= c["ts"] + c["dur"]
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert names[seen["tid"]] == "pack-like"
    alone = str(tmp_path / "alone.json")
    trace.export_chrome(alone)
    with open(alone) as f:
        got = {e["name"] for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X"}
    assert got == {"worker_span", "caller_span"}


def test_export_files_a_worker_under_the_tid_of_its_cuda_calls(tmp_path):
    """A thread the profiler does not record shows up in a card's trace
    only through its CUDA runtime calls, under a thread id of CUPTI's: its
    spans go to the row whose calls fall inside them."""
    trace.timeline_start()

    def worker():
        with trace.span("dispatch.mc", pic=2):
            time.sleep(0.002)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    with trace.span("caller"):
        time.sleep(0.002)
    trace.timeline_stop()
    w, c = trace.timeline()
    base = w.start_ns - 10_000
    inside = (w.start_ns - base) / 1e3 + 500.0
    doc = {"baseTimeNanoseconds": base, "traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "pid": 1,
         "tid": c.tid, "ts": (c.start_ns - base) / 1e3, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 987654, "ts": inside, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 555, "ts": inside + 1e6, "dur": 1.0}]}
    path = str(tmp_path / "m.json")
    trace.export_chrome(path, doc)
    with open(path) as f:
        got = {e["name"]: e for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"}
    assert got["dispatch.mc"]["tid"] == 987654
    assert abs(got["dispatch.mc"]["ts"] - 10.0) < 1e-6
    assert got["caller"]["tid"] == c.tid


def test_upload_counts_the_bytes_it_copies():
    a = np.arange(24, dtype=np.int16).reshape(4, 6)[:, ::2]
    t = tables.upload(a, CPU)
    assert np.array_equal(t.numpy(), a)
    planes = [np.zeros((8, 8), np.uint8), np.zeros((4, 4), np.uint8)]
    tables.dpb_from_numpy(planes, CPU)
    assert trace.report()["h2d_bytes"]["total"] == a.nbytes + 4 * (64 + 16)


@pytest.mark.skipif(not native.available(),
                    reason="native toolchain unavailable")
def test_h2d_bytes_sums_the_frame_programs_uploads(monkeypatch):
    aus = _aus(3)
    _decode(aus)  # warms the cached scaling banks and tables
    want = []
    real = pipeline.frame_program

    def spy(meta, meta16, meta8, avail_u8, levels16, scale_bank, canvas0,
            refs_y, refs_cb, refs_cr, spec, device):
        S = dict(spec)
        n = np.asarray(meta, np.int32).nbytes + np.asarray(meta8).nbytes \
            + np.asarray(avail_u8).nbytes
        n += sum(np.asarray(x).nbytes for x in levels16) if S["coo"][0] \
            else np.asarray(levels16).nbytes
        shape = canvas0
        if not isinstance(canvas0, tuple):
            n += np.asarray(canvas0).nbytes
            shape = np.asarray(canvas0).shape
        if S["n_refs"]:
            groups = pipeline.host_views(np.asarray(meta, np.int32), meta16,
                                         S)[3]
            n += mc_cuda.mc_table(groups, shape).rows.nbytes
        want.append((n, S["n_refs"]))
        return real(meta, meta16, meta8, avail_u8, levels16, scale_bank,
                    canvas0, refs_y, refs_cb, refs_cr, spec, device)

    monkeypatch.setattr(pipeline, "frame_program", spy)
    trace.reset()
    _decode(aus)
    assert len(want) == 3 and any(r for _, r in want)
    assert trace.report()["h2d_bytes"]["total"] == sum(n for n, _ in want)
