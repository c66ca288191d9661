"""The reference's plane digests of every picture of a bank segment,
cached per segment under ``build/ref/`` (keyed by the segment's SHA-256,
the output layer and the reference's own sources), and computed in
worker processes, one a segment, where the cache has none.

The reference takes about 3 s a 1920x1080 inter picture on one core and
16 s an intra one at QP 27, so a checkout's first run of a cell pays about
two minutes after its window; later runs read the cache.
"""
from __future__ import annotations

import glob
import hashlib
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List

from . import bank, check

REF_DIR = os.path.join(bank.HERE, "reference")


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(glob.glob(os.path.join(REF_DIR, "**", "*.py"),
                              recursive=True)):
        h.update(os.path.relpath(p, REF_DIR).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _path(seg: bank.Segment, layer: int, src: str) -> str:
    return os.path.join(bank.BUILD, "ref",
                        f"{seg.sha256[:16]}.layer{layer}.{src}.json")


def segment_digests(aus: List[bytes], layer: int) -> List[List[str]]:
    """The reference's plane digests of each access unit's picture, in
    decode order (run in a worker process)."""
    from .reference import decode
    out: Dict[int, List[str]] = {}
    for i, planes, bd in decode(aus, layer):
        if i in out:
            raise ValueError(f"the reference output access unit {i} twice")
        out[i] = check.plane_digests(planes, bd)
    if sorted(out) != list(range(len(aus))):
        raise ValueError(f"the reference output {len(out)} pictures for "
                         f"{len(aus)} access units")
    return [out[i] for i in range(len(aus))]


def digests(segments: List[bank.Segment], layer: int,
            jobs: int) -> Dict[int, List[List[str]]]:
    """segment index -> the reference's plane digests of its pictures."""
    src = _sources_hash()
    out, todo = {}, []
    for seg in segments:
        p = _path(seg, layer, src)
        if os.path.exists(p):
            with open(p) as f:
                out[seg.index] = json.load(f)
        else:
            todo.append(seg)
    if todo:
        os.makedirs(os.path.dirname(_path(todo[0], layer, src)),
                    exist_ok=True)
        with ProcessPoolExecutor(max(1, min(len(todo), jobs)),
                                 mp_context=mp.get_context("spawn")) as pool:
            futs = [(seg, pool.submit(segment_digests, list(seg.aus), layer))
                    for seg in todo]
            for seg, fut in futs:
                out[seg.index] = fut.result()
                p = _path(seg, layer, src)
                tmp = f"{p}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    json.dump(out[seg.index], f)
                os.replace(tmp, p)
    return out
