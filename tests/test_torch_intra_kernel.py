"""The intra wavefront kernel's wrapper (hevc_tpu_torch/intra_cuda.py) and
what the kernel (csrc/intra.cu) relies on, on the CPU.

- The wrapper runs the plain version on CPU tensors; on the seeded random
  cases of ``hevc_tpu_torch.intra_cases`` (every mode of every size, the
  filter flags on and off, bit depths 8 and 10, partial and empty
  availability, padding records, empty chunks) it equals the JAX
  package's ``reconstruct_wavefront`` bit for bit (tolerance 0).
- A NumPy mirror of the kernel's per-record steps (its scan-order
  substitution by 32-position ballots, the [1 2 1] filter along the scan
  order, the strong ramps, one mode's prediction) equals the plain
  version on the same cases.
- For a tensor that is not on the CPU the wrapper checks and launches or
  raises; it never falls back to the plain version.
- The pack's output never breaks the kernel's assumptions: on every
  picture of the streams of tests/test_pipeline.py CONFIGS, an SHVC
  stream's two layers and a banded stream's bands, no record reads an
  available sample that another record of its chunk writes, and no real
  record trips the plain version's padding test.
- ``bounds.intra_work`` against a NumPy recount.

The card test (kernel against plain on the same random cases) is in
tests/test_torch_cuda.py.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu import native
from hevc_tpu.tpu.intra import reconstruct_wavefront as jax_wavefront
from hevc_tpu_torch import band, build, intra, intra_cuda
from hevc_tpu_torch import pipeline as PP
from hevc_tpu_torch.bounds import intra_work
from hevc_tpu_torch.decoder import TorchDecoder
from hevc_tpu_torch.intra import SIZES, chunk_counts
from hevc_tpu_torch.intra_cases import (EMPTY_CHUNKS, MODES, modes_of,
                                        random_case)
from hevc_tpu_torch.pack import DUMP
from hevc_tpu_torch.tables import tables_from_reference
from test_pipeline import CONFIGS as PIPELINE_CONFIGS
from torch_gate import native_ready
from torch_streams import encode_config, shvc_stream

CPU = torch.device("cpu")
TABLES = tables_from_reference(CPU)
SEEDS = range(6)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plain(case, counts=None):
    canvas, scal, avail, resids, bd = case
    return intra_cuda.reconstruct_wavefront(
        torch.from_numpy(canvas.copy()), _t(scal), _t(avail), _t(resids), bd,
        TABLES, chunk_counts(scal) if counts is None else counts).numpy()


# ---------------------------------------------------------------------------
# the random cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_wrapper_on_the_cpu_matches_jax_on_random_cases(seed):
    case = random_case(seed)
    canvas, scal, avail, resids, bd = case
    want = np.asarray(jax_wavefront(
        jnp.asarray(canvas), tuple(map(jnp.asarray, scal)),
        tuple(map(jnp.asarray, avail)), tuple(map(jnp.asarray, resids)), bd,
        scal[0].shape[0]))
    got = _plain(case)
    assert np.array_equal(got, want)
    assert (got != canvas).sum() > 0.5 * sum(
        int((s[..., 0] != DUMP).sum()) * (4 << c) ** 2
        for c, s in enumerate(scal)) / 4


def test_random_cases_cover_what_the_kernel_must_take():
    """Every mode of every size in each case; the flags on and off;
    both bit depths; full, empty and partial availability; padding slots
    between records; empty chunks; residual slots past the pool."""
    bds, flags, kinds, past = set(), set(), set(), set()
    for seed in SEEDS:
        canvas, scal, avail, resids, bd = random_case(seed)
        assert modes_of(scal) == set(MODES)
        bds.add(bd)
        counts = chunk_counts(scal)
        assert all(int(cnt[k]) == 0 for cnt in counts for k in EMPTY_CHUNKS)
        for c, (s, a) in enumerate(zip(scal, avail)):
            live = s[..., 0] != DUMP
            assert (~live).any(axis=1).all(), "a padding slot each chunk"
            # padding before a record in some chunk
            assert any(np.nonzero(~row)[0][0] < np.nonzero(row)[0][-1]
                       for row in live if row.any())
            rec = s[live]
            flags |= {(c, f, int(v)) for f in (4, 5, 6) for v in rec[:, f]}
            if (rec[:, 3] >= resids[c].shape[0]).any():
                past.add(c)
            n2 = 2 * (4 << c)
            av = np.concatenate([a[live][:, :n2], a[live][:, 64:64 + n2]], 1)
            kinds |= {"all" if r.all() else "none" if not r.any()
                      else "part" for r in av}
    assert bds == {8, 10}
    assert flags == {(c, f, v) for c in range(4) for f in (4, 5, 6)
                     for v in (0, 1)}
    assert kinds == {"all", "none", "part"}
    assert past == {0, 1, 2, 3}


def _mirror(canvas, scal, avail, resids, bd, counts):
    """The kernel's steps in NumPy, record by record, written after
    csrc/intra.cu (indices as the kernel computes them)."""
    out = canvas.astype(np.int64).copy()
    ch, cw = out.shape
    flat = out.reshape(-1)
    ang_tab, inv_tab = kernel_tables()
    half, maxv = 1 << (bd - 1), (1 << bd) - 1
    for k in range(scal[0].shape[0]):
        for c, n in enumerate(SIZES):
            if not int(counts[c][k]):
                continue
            for s, av in zip(scal[c][k], avail[c][k]):
                cy, cx = int(s[0]), int(s[1])
                n2, L = 2 * n, 4 * n + 1
                if cy < 1 or cx < 1 or cy + n2 > ch or cx + n2 > cw:
                    continue
                mode, slot = int(s[2]), min(max(int(s[3]), 0),
                                            resids[c].shape[0] - 1)
                a = np.zeros(L, np.int64)
                m = np.zeros(L, bool)
                for j in range(L):
                    if j < n2:
                        i = n2 - 1 - j
                        a[j], m[j] = flat[(cy + i) * cw + cx - 1], av[i]
                    elif j == n2:
                        a[j], m[j] = flat[(cy - 1) * cw + cx - 1], s[7] != 0
                    else:
                        i = j - n2 - 1
                        a[j], m[j] = flat[(cy - 1) * cw + cx + i], av[64 + i]
                # ballots of 32 positions, the last available one carried
                src, carry, first = np.zeros(L, int), -1, -1
                for t in range((L + 31) // 32):
                    bits = m[32 * t:32 * t + 32]
                    for lane in range(len(bits)):
                        le = np.nonzero(bits[:lane + 1])[0]
                        src[32 * t + lane] = 32 * t + le[-1] if le.size \
                            else carry
                    if bits.any():
                        carry = 32 * t + np.nonzero(bits)[0][-1]
                        if first < 0:
                            first = 32 * t + np.nonzero(bits)[0][0]
                b = np.array([half if first < 0 else
                              a[src[j] if src[j] >= 0 else first]
                              for j in range(L)])
                f = b
                if s[4]:
                    f = b.copy()
                    flatc = False
                    if c == 3 and s[5]:
                        c0, l63, t63 = b[n2], b[0], b[L - 1]
                        thr = 1 << (bd - 5)
                        flatc = (abs(c0 + t63 - 2 * b[n2 + n]) < thr
                                 and abs(c0 + l63 - 2 * b[n2 - n]) < thr)
                    for j in range(L):
                        if flatc:
                            if j < n2 and n2 - 1 - j < n2 - 1:
                                i = n2 - 1 - j
                                f[j] = ((62 - i) * c0 + (i + 1) * l63
                                        + 32) >> 6
                            elif j > n2 and j - n2 - 1 < n2 - 1:
                                i = j - n2 - 1
                                f[j] = ((62 - i) * c0 + (i + 1) * t63
                                        + 32) >> 6
                        elif 0 < j < L - 1:
                            f[j] = (b[j - 1] + 2 * b[j] + b[j + 1] + 2) >> 2
                left = lambda i: f[n2 - 1 - i]  # noqa: E731
                top = lambda i: f[n2 + 1 + i]   # noqa: E731
                corner = f[n2]
                log2n = c + 2
                res = resids[c][slot].astype(np.int64)
                pred = np.zeros((n, n), np.int64)
                if mode == 0:
                    for y in range(n):
                        for x in range(n):
                            pred[y, x] = ((n - 1 - x) * left(y) + (x + 1)
                                          * top(n) + (n - 1 - y) * top(x)
                                          + (y + 1) * left(n) + n) \
                                >> (log2n + 1)
                elif mode == 1:
                    dc = (sum(top(i) + left(i) for i in range(n)) + n) \
                        >> (log2n + 1)
                    pred[:] = dc
                    if n < 32 and s[6]:
                        for x in range(1, n):
                            pred[0, x] = (top(x) + 3 * dc + 2) >> 2
                        for y in range(1, n):
                            pred[y, 0] = (left(y) + 3 * dc + 2) >> 2
                        pred[0, 0] = (left(0) + 2 * dc + top(0) + 2) >> 2
                else:
                    mm = min(max(mode, 0), 34)
                    angle, inv = ang_tab[mm], inv_tab[mm]
                    vert = mode >= 18
                    ext = np.zeros(3 * n + 3, np.int64)
                    for t in range(3 * n + 3):
                        if t < n:
                            sidx = ((-(n - t) * inv + 128) >> 8) - 1
                            i = min(max(sidx, 0), n2 - 1)
                            ext[t] = corner if sidx < 0 else (
                                left(i) if vert else top(i))
                        elif t == n:
                            ext[t] = corner
                        elif t <= 3 * n + 1:
                            i = min(t - n - 1, n2 - 1)
                            ext[t] = top(i) if vert else left(i)
                    last = 3 * n + 2
                    for y in range(n):
                        for x in range(n):
                            prod = ((y if vert else x) + 1) * angle
                            ii, ff = prod >> 5, prod & 31
                            pos = min(max(n + (x if vert else y) + ii + 1,
                                          0), last)
                            v = ((32 - ff) * ext[pos] + ff
                                 * ext[min(pos + 1, last)] + 16) >> 5
                            if s[6] and mode == 26 and x == 0:
                                v = min(max(top(0) + ((left(y) - corner)
                                                      >> 1), 0), maxv)
                            elif s[6] and mode == 10 and y == 0:
                                v = min(max(left(0) + ((top(x) - corner)
                                                       >> 1), 0), maxv)
                            pred[y, x] = v
                out[cy:cy + n, cx:cx + n] = np.clip(pred + res, 0, maxv)
                flat = out.reshape(-1)
    return out.astype(np.int32)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_a_numpy_mirror_of_the_kernel_matches_the_plain_version(seed):
    case = random_case(seed)
    canvas, scal, avail, resids, bd = case
    counts = chunk_counts(scal)
    assert np.array_equal(_mirror(canvas, scal, avail, resids, bd, counts),
                          _plain(case))


def kernel_tables():
    """``c_angle`` and ``c_invangle`` of csrc/intra.cu."""
    src = open(os.path.join(os.path.dirname(build.__file__), "csrc",
                            "intra.cu")).read()
    out = []
    for name in ("c_angle", "c_invangle"):
        body = re.search(name + r"\[35\] = \{(.*?)\};", src, re.S).group(1)
        out.append([int(v) for v in re.findall(r"-?\d+", body)])
    return out


def test_kernel_angle_tables_are_the_reference_tables():
    angle, inv = kernel_tables()
    assert angle == TABLES["angle"].tolist()
    assert inv == TABLES["invangle"].tolist()


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the wrapper is ``intra.reconstruct_wavefront``, the
    host counts optional as there, and no launch is counted."""
    calls = []
    plain = intra.reconstruct_wavefront

    def spy(*a):
        calls.append(1)
        return plain(*a)

    monkeypatch.setattr(intra, "reconstruct_wavefront", spy)
    before = build.launches["intra"]
    case = random_case(0)
    a = _plain(case)
    canvas, scal, avail, resids, bd = case
    b = intra_cuda.reconstruct_wavefront(
        torch.from_numpy(canvas.copy()), _t(scal), _t(avail), _t(resids), bd,
        TABLES).numpy()
    assert np.array_equal(a, b) and len(calls) == 2
    assert build.launches["intra"] == before


def _meta_case():
    """The shapes of a random case as tensors that lie on no CPU."""
    canvas, scal, avail, resids, bd = random_case(1)
    meta = lambda a: torch.empty(a.shape, dtype=torch.from_numpy(  # noqa
        a[:0].copy()).dtype, device="meta")
    return (meta(canvas), [meta(s) for s in scal], [meta(a) for a in avail],
            [meta(r) for r in resids], bd, chunk_counts(scal))


def test_wrapper_raises_when_the_build_fails_and_never_falls_back(
        monkeypatch):
    """Off the CPU the wrapper launches or raises: with the kernel library
    failing to build, the call raises that error and the plain version
    is never called."""
    def failed():
        raise RuntimeError("nvcc failed (1): no such card")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(build, "load", failed)
    monkeypatch.setattr(intra, "reconstruct_wavefront", plain)
    canvas, scal, avail, resids, bd, counts = _meta_case()
    before = build.launches["intra"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        intra_cuda.reconstruct_wavefront(canvas, scal, avail, resids, bd,
                                         TABLES, counts)
    assert build.launches["intra"] == before


@pytest.mark.parametrize("fault", ["counts", "dtype", "shape", "device",
                                   "contiguous", "chunks", "bd"])
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, fault):
    monkeypatch.setattr(build, "load", lambda: pytest.fail("launched"))
    canvas, scal, avail, resids, bd, counts = _meta_case()
    if fault == "counts":
        counts = None
    elif fault == "dtype":
        scal[1] = scal[1].to(torch.int64)
    elif fault == "shape":
        avail[2] = avail[2][:, :, :64]
    elif fault == "device":
        resids[0] = torch.zeros(resids[0].shape, dtype=torch.int32)
    elif fault == "contiguous":
        canvas = torch.empty(canvas.shape[::-1], dtype=torch.int32,
                             device="meta").t()
    elif fault == "chunks":
        counts = [c[:-1] for c in counts]
    elif fault == "bd":
        bd = 4
    with pytest.raises(ValueError):
        intra_cuda.reconstruct_wavefront(canvas, scal, avail, resids, bd,
                                         TABLES, counts)


def test_chunk_table_counts_the_live_chunks():
    _c, scal, _a, _r, _bd = random_case(2)
    counts = chunk_counts(scal)
    table = intra_cuda.chunk_table(counts)
    assert table.dtype == np.int32 and table.shape == (scal[0].shape[0], 4)
    assert table.flags.c_contiguous
    assert intra_cuda.live_chunks(counts) == \
        scal[0].shape[0] - len(EMPTY_CHUNKS)
    assert [list(table[:, c]) for c in range(4)] == \
        [list(c) for c in counts]


# ---------------------------------------------------------------------------
# the pack's output and the kernel's assumptions
# ---------------------------------------------------------------------------

def conflicts(scal, avail, shape):
    """(reads, pads) of one picture's (or band's) records: each record
    that reads an available sample another record of its chunk writes,
    as (chunk, its (cy, cx), the writer's (cy, cx)), and each real record
    (cy >= 0) that trips the plain version's padding test."""
    ch, cw = shape
    owner = np.full(ch * cw, -1, np.int64)
    reads, pads = [], []
    for k in range(scal[0].shape[0]):
        recs = []
        for c, n in enumerate(SIZES):
            s = scal[c]
            for j in np.nonzero(s[k, :, 0] >= 0)[0]:
                cy, cx = int(s[k, j, 0]), int(s[k, j, 1])
                if cy < 1 or cx < 1 or cy + 2 * n > ch or cx + 2 * n > cw:
                    pads.append((k, cy, cx, n))
                    continue
                recs.append((n, cy, cx, avail[c][k, j], bool(s[k, j, 7])))
        blocks = []
        for r, (n, cy, cx, _av, _avc) in enumerate(recs):
            idx = ((cy + np.arange(n))[:, None] * cw + cx
                   + np.arange(n)[None]).reshape(-1)
            owner[idx] = r
            blocks.append(idx)
        for r, (n, cy, cx, av, avc) in enumerate(recs):
            i = np.arange(2 * n)
            pos = np.concatenate([(cy + i) * cw + cx - 1,
                                  [(cy - 1) * cw + cx - 1],
                                  (cy - 1) * cw + cx + i])
            ok = np.concatenate([av[:2 * n], [avc], av[64:64 + 2 * n]])
            o = owner[pos[ok]]
            for w in np.unique(o[(o >= 0) & (o != r)]):
                reads.append((k, (cy, cx), recs[w][1:3]))
        for idx in blocks:
            owner[idx] = -1
    return reads, pads


def _program_records(stream):
    """Per picture through ``TorchDecoder(device="cpu")``'s frame
    program: (layer, scal, avail, canvas shape) from its packed buffers,
    as the frame program cuts them."""
    out, layer = [], []
    orig_finish, orig_program = PP.finish_frame, PP.frame_program

    def finish(pic, lay, poc, device):
        layer.append(lay.layer_id)
        return orig_finish(pic, lay, poc, device)

    def program(meta, meta16, meta8, avail_u8, levels16, bank, canvas0,
                *rest):
        S = dict(rest[-2])
        scal = PP.host_views(np.asarray(meta, np.int32), meta16, S)[0]
        avail, pos = [], 0
        for c in range(4):
            n = S["n_chunks"] * S["B"][c] * 128
            avail.append(np.asarray(avail_u8[pos:pos + n]).reshape(
                S["n_chunks"], S["B"][c], 128) != 0)
            pos += n
        shape = canvas0 if isinstance(canvas0, tuple) else canvas0.shape
        out.append((layer[-1], [s.copy() for s in scal], avail,
                    tuple(shape)))
        return orig_program(meta, meta16, meta8, avail_u8, levels16, bank,
                            canvas0, *rest)

    PP.finish_frame, PP.frame_program = finish, program
    try:
        frames = TorchDecoder(check_md5=True,
                              device="cpu").decode_bytes(stream)
    finally:
        PP.finish_frame, PP.frame_program = orig_finish, orig_program
    assert all(f.md5_ok for f in frames)
    return out


def _band_records():
    """Per picture and band of a 128x96 IPP stream in 4 column tiles,
    decoded in 4 bands: (band, scal, avail, canvas shape)."""
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    cfg = EncoderConfig(width=128, height=96, qp=30, gop="ipp",
                        deblocking=True, sao=True, search_range=3,
                        log2_ctb_size=5, log2_cu_size=5, seed=2,
                        tiles=(4, 1))
    enc = IntraEncoder(cfg)
    stream = b"".join(enc.encode_frame(synth_frame("noise", 128, 96, t,
                                                   seed=4)) for t in range(3))
    frames, _ref, _halo = band.prepare_gop_banded(stream, 4)
    return [(k, pf.scal, pf.avail, pf.canvas.shape)
            for fb in frames for k, pf in fb["bands"].items()]


SCHEDULE_STREAMS = sorted(PIPELINE_CONFIGS) + ["shvc_x2", "banded_ipp4"]


@pytest.mark.skipif(not native_ready(native),
                    reason="native toolchain unavailable")
@pytest.mark.parametrize("name", SCHEDULE_STREAMS)
def test_no_record_reads_what_its_own_chunk_writes(name):
    if name == "banded_ipp4":
        pics = _band_records()
    elif name == "shvc_x2":
        pics = _program_records(shvc_stream("x2"))
        assert {p[0] for p in pics} == {0, 1}
    else:
        pics = _program_records(encode_config(*PIPELINE_CONFIGS[name]))
    n_rec = 0
    for what, scal, avail, shape in pics:
        reads, pads = conflicts(scal, avail, shape)
        assert not reads, f"{name} {what}: reads of its chunk's writes " \
            f"{reads[:5]}"
        assert not pads, f"{name} {what}: real records the padding test " \
            f"takes {pads[:5]}"
        n_rec += sum(int((s[..., 0] >= 0).sum()) for s in scal)
    assert n_rec > 0, name


def test_conflicts_finds_a_read_of_its_chunks_write():
    """The check itself: two records of one chunk, the second reading the
    first's block as available, and a real record past the canvas."""
    scal = [np.zeros((1, 2, 8), np.int32)] + [np.zeros((1, 0, 8), np.int32)
                                              for _ in range(3)]
    avail = [np.zeros((1, 2, 128), bool)] + [np.zeros((1, 0, 128), bool)
                                             for _ in range(3)]
    scal[0][0, 0, :2] = (8, 8)
    scal[0][0, 1, :2] = (8, 12)          # left column x = 11: the first's
    avail[0][0, 1, :8] = True
    assert conflicts(scal, avail, (40, 40)) == ([(0, (8, 12), (8, 8))], [])
    avail[0][0, 1, :8] = False
    assert conflicts(scal, avail, (40, 40)) == ([], [])
    assert conflicts(scal, avail, (14, 40))[1] == [(0, 8, 8, 4),
                                                   (0, 8, 12, 4)]


# ---------------------------------------------------------------------------
# bounds.intra_work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["random", "tiles"])
def test_intra_work_matches_a_numpy_recount(source):
    if source == "random":
        _c, scal, _a, resids, _bd = random_case(3)
        pics = [(scal, resids)]
    else:
        pics = [(scal, [np.zeros((9, 4 << c, 4 << c)) for c in range(4)])
                for _l, scal, _a, _s in _program_records(
                    encode_config(*PIPELINE_CONFIGS["tiles"]))]
    total = 0
    for scal, resids in pics:
        counts = chunk_counts(scal)
        want_b, slots, live = 0, [set() for _ in range(4)], set()
        for c, s in enumerate(scal):
            n = 4 << c
            for k in range(s.shape[0]):
                for row in s[k]:
                    if row[0] >= 0:
                        want_b += 32 + 128 + 4 * (4 * n + 1) + 4 * n * n
                        slots[c].add(min(max(int(row[3]), 0),
                                         resids[c].shape[0] - 1))
                        live.add(k)
        want_b += sum(4 * (4 << c) ** 2 * len(s) for c, s in enumerate(slots))
        assert intra_work(scal, counts, resids) == (want_b, len(live))
        total += want_b
    assert total > 0
