"""Spans and counters of the port's decode: where each layer works, where
it waits, and what it moves.

Always on, cheap enough to stay compiled in:

- ``span(name)`` accumulates calls, wall seconds and self seconds (less
  the spans nested in it on its thread) per name (``time.perf_counter``);
- ``count(name, n)`` accumulates a counter (``h2d_bytes``, ``d2h_bytes``,
  ``device_allocs``, ``loop_filter_launches``, ``intra_launches``,
  ``pack_map_cells``, ``api_layer_held``, ``api_layer_dropped``);
- ``report()`` returns both, and the wall seconds since ``reset()`` under
  the reserved name ``WALL``.  Accumulation is thread-safe: the caller,
  the pack worker and the fetch worker all record.

Recorded on request:

- a timeline (``timeline_start()`` / ``timeline_stop()``, off by default):
  one ``Record`` a span, with the picture id (the ``pts`` the API call
  handed in), the thread, the parent span and start and end in Unix
  nanoseconds, the clock of a ``torch.profiler`` chrome trace
  (``baseTimeNanoseconds`` plus ``ts``).  The buffer keeps the newest
  ``capacity`` records and counts what it drops;
- while ``torch.profiler`` records on the calling thread, each span also
  opens a ``record_function`` range of its name, so the profiler's trace
  names the host's work by the program's spans.

``export_chrome`` writes the timeline and the counters' totals as a
chrome trace, alone or merged into a ``torch.profiler`` trace on its
clock (``python -m hevc_tpu_torch.cli -i in.265 --trace-out t.json``).

Usage:
    from hevc_tpu_torch import trace
    with trace.span("stage_a_native", pic=pts):
        ...
    trace.count("h2d_bytes", a.nbytes)
    trace.report()  # {"stage_a_native": {"calls", "total_s", "self_s"},
                    #  "h2d_bytes": {"calls", "total"}, "_wall": {"total_s"}}
"""
from __future__ import annotations

import bisect
import itertools
import json
import os
import sys
import threading
import time
from collections import Counter, deque
from typing import NamedTuple, Optional

WALL = "_wall"  # report()'s name for the wall seconds since reset()
CAPACITY = 100_000  # the timeline's records, by default

_lock = threading.Lock()
_acc = {}  # span name -> [calls, total_ns, self_ns]
_cnt = {}  # counter name -> [calls, total]
_t_reset = time.perf_counter_ns()
_line: Optional[deque] = None  # the timeline while it records
_kept: list = []  # the last recording's records, once stopped
_dropped = 0
_offset = 0  # Unix ns minus perf_counter ns, fixed when the timeline starts
_ids = itertools.count(1)
_local = threading.local()  # .open: this thread's open spans, innermost last
_profiler_enabled = None


class Record(NamedTuple):
    """One span on the timeline; times in Unix nanoseconds."""
    name: str
    pic: Optional[int]
    thread: str
    tid: int  # the native thread id
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    profiled: bool  # a record_function range of it is in the profiler


class Handoff(NamedTuple):
    """Work handed to another thread: the id its span will take, its
    picture, its parent (the submitting thread's innermost open span) and
    when it was handed over (``perf_counter_ns``)."""
    id: int
    pic: Optional[int]
    parent: Optional[int]
    t0: int


def _profiling() -> bool:
    """Whether torch.profiler records on this thread (a profiler needs
    torch imported, so without torch this is False at once)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _profiler_enabled = torch.autograd._profiler_enabled
    return _profiler_enabled()


def _open() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def current():
    """(id, pic) of this thread's innermost open span, or None; the id is
    None unless the timeline recorded when the span opened."""
    o = _open()
    return (o[-1].sid, o[-1].pic) if o else None


def _append(rec: Record) -> None:
    global _dropped
    with _lock:
        line = _line
        if line is None:
            return
        if len(line) == line.maxlen:
            _dropped += 1
        line.append(rec)


def _record(name, pic, sid, parent, t0, t1, profiled) -> None:
    th = threading.current_thread()
    _append(Record(name, pic, th.name, th.native_id, sid, parent,
                   t0 + _offset, t1 + _offset, profiled))


class span:
    """Time a block under ``name``: its calls, its seconds, and its self
    seconds (less the spans nested in it on its thread).  ``pic`` and
    ``parent`` default to those of the thread's innermost open span;
    ``sid`` is the span's id when the caller fixed it beforehand
    (``Handoff.id``)."""

    __slots__ = ("name", "pic", "parent", "sid", "t0", "rf", "tracked",
                 "child_ns", "stack")

    def __init__(self, name: str, pic=None, parent=None, sid=None):
        self.name = name
        self.pic = pic
        self.parent = parent
        self.sid = sid

    def __enter__(self):
        o = self.stack = _open()
        if o:
            if self.pic is None:
                self.pic = o[-1].pic
            if self.parent is None:
                self.parent = o[-1].sid
        self.tracked = _line is not None
        if self.tracked and self.sid is None:
            self.sid = next(_ids)
        self.child_ns = 0
        o.append(self)
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if _profiling():  # the range opens after t0, and closes after t1
            from torch.autograd.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dur = t1 - self.t0
        o = self.stack
        o.pop()
        if o:
            o[-1].child_ns += dur
        with _lock:
            a = _acc.get(self.name)
            if a is None:
                a = _acc[self.name] = [0, 0, 0]
            a[0] += 1
            a[1] += dur
            a[2] += dur - self.child_ns
        if self.tracked:
            _record(self.name, self.pic, self.sid, self.parent, self.t0, t1,
                    self.rf is not None)
        return False


def handoff(pic=None) -> Handoff:
    """Mark work handed to another thread now (see ``Handoff``); ``pic``
    defaults to the innermost open span's."""
    top = current()
    if pic is None and top is not None:
        pic = top[1]
    return Handoff(next(_ids), pic, top[0] if top else None,
                   time.perf_counter_ns())


def waited(name: str, h: Handoff) -> None:
    """Record span ``name`` from ``h``'s hand-over to now: the time the
    work waited to be taken up.  Called by the thread that takes it up."""
    t1 = time.perf_counter_ns()
    with _lock:
        a = _acc.get(name)
        if a is None:
            a = _acc[name] = [0, 0, 0]
        a[0] += 1
        a[1] += t1 - h.t0
        a[2] += t1 - h.t0
    if _line is not None:
        _record(name, h.pic, next(_ids), h.parent, h.t0, t1, False)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` (a zero still marks it recorded)."""
    with _lock:
        c = _cnt.get(name)
        if c is None:
            c = _cnt[name] = [0, 0]
        c[0] += 1
        c[1] += n


def reset() -> None:
    """Clear the accumulators and counters and restart the wall clock."""
    global _t_reset
    with _lock:
        _acc.clear()
        _cnt.clear()
        _t_reset = time.perf_counter_ns()


def report() -> dict:
    """Spans as {"calls", "total_s", "self_s"}, counters as {"calls",
    "total"}, and ``WALL``: {"total_s"}, the wall seconds since
    ``reset()``."""
    with _lock:
        now = time.perf_counter_ns()
        out = {k: {"calls": v[0], "total_s": round(v[1] / 1e9, 6),
                   "self_s": round(v[2] / 1e9, 6)}
               for k, v in sorted(_acc.items())}
        out.update({k: {"calls": v[0], "total": v[1]}
                    for k, v in sorted(_cnt.items())})
        out[WALL] = {"total_s": round((now - _t_reset) / 1e9, 6)}
    return out


def _clock_offset() -> int:
    """Unix ns minus perf_counter ns, from the tightest of a few reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def timeline_start(capacity: int = CAPACITY) -> None:
    """Start recording the timeline, emptied, keeping at most ``capacity``
    records."""
    global _line, _dropped, _offset
    with _lock:
        _offset = _clock_offset()
        _dropped = 0
        _line = deque(maxlen=capacity)


def timeline_stop() -> list:
    """Stop recording; returns the records (also kept for ``timeline()``
    and ``export_chrome``)."""
    global _line, _kept
    with _lock:
        _kept = list(_line or ())
        _line = None
    return _kept


def timeline() -> list:
    """The records so far (while recording) or of the last recording."""
    with _lock:
        return list(_line) if _line is not None else list(_kept)


def dropped() -> int:
    """Records the timeline dropped, oldest first, since it started."""
    return _dropped


def _union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _trace_tids(records, events, base_ns: int) -> dict:
    """Native thread id -> the ``tid`` under which a profiler trace
    (``events``) files that thread's work.  A thread the profiler recorded
    itself keeps its id; one whose CUDA calls alone reached the trace
    (CUPTI names it by an id of its own) takes the ``tid`` of the most
    ``cuda_runtime`` events that fall inside its spans."""
    present = {e.get("tid") for e in events if e.get("ph") == "X"}
    spans = {}
    for r in records:
        spans.setdefault(r.tid, []).append(
            ((r.start_ns - base_ns) / 1e3, (r.end_ns - base_ns) / 1e3))
    calls = sorted((e["ts"], e["tid"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                   and e.get("tid") not in spans)
    out = {}
    for tid, iv in spans.items():
        if tid in present:
            out[tid] = tid
            continue
        votes = Counter()
        for a, b in _union(iv):
            lo = bisect.bisect_left(calls, (a,))
            hi = bisect.bisect_right(calls, (b, float("inf")))
            votes.update(t for _, t in calls[lo:hi])
        out[tid] = votes.most_common(1)[0][0] if votes else tid
    return out


def _chrome_events(records, base_ns: int, pid, tids=None,
                  skip_profiled=False) -> list:
    """``records`` as chrome-trace complete events (``ts``/``dur`` in µs
    from ``base_ns``), category ``user_annotation``, one ``tid`` a thread
    (``tids`` maps native ids to others), with a ``thread_name`` event for
    each thread."""
    tids = tids or {}
    events, names = [], {}
    for r in records:
        tid = tids.get(r.tid, r.tid)
        names.setdefault(tid, r.thread)
        if skip_profiled and r.profiled:
            continue
        events.append({
            "ph": "X", "cat": "user_annotation", "name": r.name,
            "pid": pid, "tid": tid,
            "ts": (r.start_ns - base_ns) / 1e3,
            "dur": (r.end_ns - r.start_ns) / 1e3,
            "args": {"pic": r.pic, "span": r.id, "parent": r.parent}})
    for tid, name in names.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    return events


def _counter_events(records, base_ns: int, pid) -> list:
    """The counters' totals since ``reset()`` as chrome-trace counter
    events, at the end of the last record."""
    end = max((r.end_ns for r in records), default=base_ns)
    with _lock:
        totals = {k: v[1] for k, v in sorted(_cnt.items())}
    return [{"ph": "C", "name": k, "pid": pid, "ts": (end - base_ns) / 1e3,
             "args": {k: v}} for k, v in totals.items()]


def export_chrome(path: str, device_trace=None) -> None:
    """Write the timeline (``timeline()``) to ``path`` as a chrome trace.

    ``device_trace``, a ``torch.profiler`` chrome trace (its path or its
    loaded dict), is merged in: the spans go onto that trace's clock
    (``baseTimeNanoseconds``) under this process's ``pid``, each program
    thread on its own ``tid`` beside the trace's events of that thread;
    spans the profiler recorded itself (as ``record_function`` ranges)
    are not repeated."""
    records = timeline()
    if device_trace is None:
        base = min((r.start_ns for r in records), default=0)
        doc = {"traceEvents": [], "baseTimeNanoseconds": base,
               "displayTimeUnit": "ms"}
        tids, skip = {}, False
    else:
        if isinstance(device_trace, str):
            with open(device_trace) as f:
                doc = json.load(f)
        else:
            doc = device_trace
        base = int(doc.get("baseTimeNanoseconds", 0))
        tids = _trace_tids(records, doc["traceEvents"], base)
        skip = True
    doc["traceEvents"].extend(_chrome_events(records, base, os.getpid(),
                                            tids, skip_profiled=skip))
    doc["traceEvents"].extend(_counter_events(records, base, os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)
