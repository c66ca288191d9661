"""The benchmark's data: its manifest, configurations, traffic mixes and
bank of encoded segments, and the one generator that turns a traffic mix
and a seed into the sequence of access units a run decodes.

Everything here is plain Python and NumPy: it imports nothing of the
program under test.

Layout, all found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: a deployment (format, layers, encoder
  settings, guarantee, source, ``reduced`` and ``assumed``);
- ``traffic/<mix>.json``: a traffic mix (structure, QP, content, the
  number and length of segments, and the composition rule);
- ``data/<config>/<mix>/bank.json`` and ``seg<k>.hevc``: the segments that
  ``make_bank.py`` encoded for that pair, each an Annex-B closed GOP that
  starts with its parameter sets and an IDR, with its SHA-256 and the
  byte size of every access unit.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# build outputs of the benchmark (reference digests, profiler traces);
# ``build/`` is git-ignored
BUILD = os.path.join(HERE, "build")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def workload(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def bank_dir(config_name: str, traffic_name: str) -> str:
    return os.path.join(HERE, "data", config_name, traffic_name)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


@dataclass(frozen=True)
class Segment:
    """One closed GOP of the bank: its index, file, SHA-256 and access
    units (each the Annex-B bytes of one access unit, in decode order)."""
    index: int
    path: str
    sha256: str
    aus: Tuple[bytes, ...]


def split_aus(data: bytes, sizes: List[int]) -> Tuple[bytes, ...]:
    if sum(sizes) != len(data):
        raise ValueError(f"access unit sizes sum to {sum(sizes)}, the "
                         f"segment has {len(data)} bytes")
    out, off = [], 0
    for n in sizes:
        out.append(data[off:off + n])
        off += n
    return tuple(out)


def load_bank(config_name: str, traffic_name: str,
              directory: str = None) -> List[Segment]:
    """Read and verify the bank of a cell (from ``directory`` in place of
    ``data/<config>/<traffic>``): every segment's SHA-256 must match
    ``bank.json``."""
    d = directory or bank_dir(config_name, traffic_name)
    meta = load_json(os.path.join(d, "bank.json"))
    segs = []
    for k, s in enumerate(meta["segments"]):
        path = os.path.join(d, s["file"])
        with open(path, "rb") as f:
            data = f.read()
        got = hashlib.sha256(data).hexdigest()
        if got != s["sha256"]:
            raise ValueError(f"{path}: SHA-256 {got}, bank.json says "
                             f"{s['sha256']}")
        segs.append(Segment(k, path, got, split_aus(data, s["au_sizes"])))
    return segs


def draw_sequence(mix: dict, n_segments: int, seed: int) -> List[int]:
    """The order in which a run decodes the bank's segments, from the seed.

    Rule ``shuffled_rounds``: ``rounds`` rounds, each every segment once in
    an order drawn from the seed, so every seed decodes the same work in
    another order; a run loops over the sequence."""
    comp = mix["composition"]
    if comp["rule"] != "shuffled_rounds":
        raise ValueError(f"unknown composition rule {comp['rule']!r}")
    rng = random.Random(seed)
    seq: List[int] = []
    for _ in range(comp["rounds"]):
        order = list(range(n_segments))
        rng.shuffle(order)
        seq += order
    return seq


def feed(segments: List[Segment], sequence: List[int]):
    """Endless (segment index, access unit index, bytes) in decode order,
    looping over ``sequence``."""
    while True:
        for k in sequence:
            for i, au in enumerate(segments[k].aus):
                yield k, i, au


def metric_readers(names: List[str]) -> Dict[str, object]:
    """The reader of each per-layer metric: ``metrics/<name>.py``'s
    ``read``."""
    import importlib.util
    out = {}
    for name in names:
        path = os.path.join(HERE, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out
