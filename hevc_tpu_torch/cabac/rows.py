"""The CABAC arithmetic engine over independent rows, one row per WPP
substream: tables, row packing, the plain PyTorch version of
``hevc_tpu/tpu/cabac_pallas.py`` and the capture of a real stream's
substreams.

A row is what one engine of 9.3.4.3 decodes from its start: its bytes, its
initial context states ((pStateIdx << 1) | valMps, ``n_ctx`` of them) and
its schedule of bin kinds (>= 0 context slot, ``BYPASS``, ``TERMINATE``).
``decode_rows`` decodes R rows at once: on a CUDA tensor through the
Hopper kernel of ``csrc/cabac.cu`` (``cabac_cuda.py``), on a CPU tensor
through ``decode_rows_plain``.

    python -m hevc_tpu_torch.cabac.rows [--device cuda]

decodes random row sets of 4,096 bins (R = 1, 8, 132, 1,024), holds the
kernel against the plain version and the encoder's bins, and prints
Mbins/s from CUDA events beside the chain bound (``chain_bound``): a row
is one dependent chain of bins, so the least time of a set is its longest
row's chain, not its bytes.
"""
from __future__ import annotations

import argparse
import sys
import time
from functools import lru_cache
from typing import List, NamedTuple

import numpy as np
import torch

from ..device import cuda_ms, max_sm_clock_mhz, resolve_device
from .ctx import ContextModel
from .engine import (RANGE_TAB_LPS, TRANS_IDX_LPS, TRANS_IDX_MPS,
                     CabacDecoder, CabacEncoder)

BYPASS = -1
TERMINATE = -2
N_CTX = len(ContextModel(0, 26).states)
# the random row sets of python -m hevc_tpu_torch.cabac.rows and
# chip_smoke.py: tools/probe_cabac_pallas.py's 4,096 bins at R = 1 and 8,
# one row per SM (132) and 1,024
N_BINS = 4096
ROWS = (1, 8, 132, 1024)
# csrc/cabac.cu: the bins of one staged chunk of the schedule (kChunk) and
# the one-warp blocks, a row each, that an SM holds (kBlocksPerSm)
CHUNK = 128
BLOCKS_PER_SM = 32
# the least loop-carried chain of one bin by kind, (shared-memory round
# trips, dependent 32-bit ALU instructions).  Context: the range quarter
# and the table index (2), the table word, then mask, subtract, compare,
# select, count leading zeros, subtract, shift (7).  Bypass: shift in a
# bit, compare, subtract.  Terminate: subtract, compare, count leading
# zeros, subtract, select, shift.
CHAIN = {"context": (1, 9), "bypass": (0, 3), "terminate": (0, 6)}

# renormalisation: _SHIFT[r] doublings bring the range r to >= 256
_SHIFT = np.asarray([0] + [max(0, 9 - r.bit_length()) for r in range(1, 512)],
                    np.int64)


class Row(NamedTuple):
    """One engine's input and the bins the Python engine decoded."""
    data: bytes
    init: List[int]
    sched: List[int]
    bins: List[int]


@lru_cache(maxsize=None)
def cabac_tables(device: torch.device) -> torch.Tensor:
    """int32 [384]: rangeTabLps [64][4], then transIdxLps [64], then
    transIdxMps [64] (Tables 9-46 and 9-47 of ``cabac/engine.py``)."""
    t = np.concatenate([np.asarray(RANGE_TAB_LPS, np.int32).ravel(),
                        np.asarray(TRANS_IDX_LPS, np.int32),
                        np.asarray(TRANS_IDX_MPS, np.int32)])
    return torch.from_numpy(t).to(device)


# the pseudo-states through which bypass and terminate bins take the
# context bin's step in ``cabac_kernel``, and the slots of the kernel's 256
# context states that hold them (schedule entry & 255)
BYPASS_STATE, TERMINATE_STATE = 130, 128
MAX_CTX = 254


@lru_cache(maxsize=None)
def cabac_step_table(device: torch.device) -> torch.Tensor:
    """int32 [132 * 4], the one word a bin of ``cabac_kernel`` reads,
    indexed by ``state * 4 + ((range >> 6) & 3)`` with state =
    (pStateIdx << 1) | valMps: bits 0-7 rangeTabLps, bits 8-15 the state
    after an LPS (valMps flipped at pStateIdx 0), bits 16-23 the state
    after an MPS (the three tables of ``cabac/engine.py``), bits 24-31 the
    doublings that bring rangeTabLps to >= 256.  After the 128 context
    states come the pseudo-states: ``TERMINATE_STATE`` (rangeTabLps 2) and
    ``BYPASS_STATE`` (rangeTabLps 0), both even (the bin is 1 when the
    offset reaches the range left) and both their own successors."""
    t = np.zeros((132, 4), np.int32)
    for s in range(128):
        p, mps = s >> 1, s & 1
        lps = (TRANS_IDX_LPS[p] << 1) | (1 - mps if p == 0 else mps)
        t[s] = [RANGE_TAB_LPS[p][q] | lps << 8
                | ((TRANS_IDX_MPS[p] << 1) | mps) << 16
                | int(_SHIFT[RANGE_TAB_LPS[p][q]]) << 24 for q in range(4)]
    t[TERMINATE_STATE] = 2 | TERMINATE_STATE << 8 | TERMINATE_STATE << 16
    t[BYPASS_STATE] = 0 | BYPASS_STATE << 8 | BYPASS_STATE << 16
    return torch.from_numpy(t.ravel()).to(device)


def random_rows(rng: np.random.Generator, R: int, n_bins: int,
                init_types=(1,), qp: int = 30, mix=(0.70, 0.25)) -> List[Row]:
    """R random schedules, each encoded with ``CabacEncoder`` from the
    contexts of init type ``init_types[k % len(init_types)]``: shares
    ``mix`` of context and bypass bins, the rest mid-stream terminates of
    value 0 (70%, 25% and 5%: the rows of ``tests/test_cabac_pallas.py``),
    closed by a terminate of 1 that is not in the schedule."""
    rows = []
    for k in range(R):
        cm = ContextModel(init_types[k % len(init_types)], qp)
        init = list(cm.states)
        kind = rng.random(n_bins)
        idx = rng.integers(0, N_CTX, n_bins)
        bit = rng.integers(0, 2, n_bins)
        enc = CabacEncoder()
        sched, bins = [], []
        for r, i, b in zip(kind.tolist(), idx.tolist(), bit.tolist()):
            if r < mix[0]:
                enc.encode_bin((cm.states, i), b)
                sched.append(i)
            elif r < mix[0] + mix[1]:
                enc.encode_bypass(b)
                sched.append(BYPASS)
            else:
                b = 0  # a terminate inside a substream is 0
                enc.encode_terminate(0)
                sched.append(TERMINATE)
            bins.append(b)
        enc.encode_terminate(1)
        enc.terminate_and_align()
        rows.append(Row(enc.getvalue(), init, sched, bins))
    return rows


def pack_rows(rows: List[Row]):
    """Rows -> (data int32 [R, n_bytes], sched int32 [R, n_bins], init
    int32 [R, n_ctx], lens int64 [R]) on the CPU.  Data is zero-padded and
    each schedule is padded with ``BYPASS`` after its row's last bin; the
    bins decoded there follow the engine's semantics on zero bytes."""
    R = len(rows)
    n_bytes = max(2, max(len(r.data) for r in rows))
    n_bins = max(1, max(len(r.sched) for r in rows))
    data = np.zeros((R, n_bytes), np.int32)
    sched = np.full((R, n_bins), BYPASS, np.int32)
    init = np.zeros((R, N_CTX), np.int32)
    for k, r in enumerate(rows):
        data[k, :len(r.data)] = np.frombuffer(r.data, np.uint8)
        sched[k, :len(r.sched)] = r.sched
        init[k] = r.init
    lens = torch.tensor([len(r.sched) for r in rows], dtype=torch.int64)
    return (torch.from_numpy(data), torch.from_numpy(sched),
            torch.from_numpy(init), lens)


# (R, n_bins) around the kernel's chunk of bins, for the tests that hold
# the plain version to the JAX kernel and the CUDA kernel to the plain one
SHAPE_GRID = ((1, 1), (3, CHUNK - 1), (5, CHUNK + 1), (33, 2 * CHUNK + 3))


def ragged_rows(R: int, n_bins: int):
    """(rows, data, sched, init, lens): R random rows of ``n_bins`` bins,
    every third one shorter so that the set has padding, packed with
    ``n_bytes`` one more than a multiple of 16: rows that start and end off
    every vector boundary."""
    rng = np.random.default_rng(R * 1000 + n_bins)
    rows = [random_rows(rng, 1, max(1, n_bins - (k % 3 == 2) * (k + 1)),
                        init_types=(k % 3,))[0] for k in range(R)]
    data, sched, init, lens = pack_rows(rows)
    pad = (1 - data.shape[1]) % 16
    data = torch.cat([data, torch.zeros((R, pad), dtype=torch.int32)], 1)
    return rows, data, sched, init, lens


def check_rows(data, sched, init, n_bins=None) -> int:
    """Validate the three tensors; returns the number of bins to decode."""
    dev = data.device
    for name, t in (("data", data), ("sched", sched), ("init", init)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"decode_rows: {name} must be int32 [R, X] on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    R = data.shape[0]
    if sched.shape[0] != R or init.shape[0] != R:
        raise ValueError("decode_rows: data, sched and init differ in rows")
    if data.shape[1] < 1 or not 1 <= init.shape[1] <= MAX_CTX:
        raise ValueError(f"decode_rows: {data.shape[1]} bytes, "
                         f"{init.shape[1]} contexts")
    n = sched.shape[1] if n_bins is None else int(n_bins)
    if not 0 <= n <= sched.shape[1]:
        raise ValueError(f"decode_rows: n_bins {n} of {sched.shape[1]}")
    if R and n and (int(sched[:, :n].min()) < TERMINATE
                    or int(sched[:, :n].max()) >= init.shape[1]):
        raise ValueError("decode_rows: schedule entry outside "
                         f"[{TERMINATE}, {init.shape[1]})")
    return n


def decode_rows_plain(data, sched, init, n_bins=None):
    """The arithmetic decode of ``cabac_pallas._cabac_kernel`` in plain
    PyTorch, vectorised over rows, one step per bin.  Returns int32
    [R, n_bins].  int32 arithmetic wraps as the JAX kernel's does (the
    offset grows past 2^31 only on bypass padding after a row's end).

    The byte cursor is kept as a bit position; a bin reads one bit
    (bypass) or the renormalisation's leading-zero count of bits
    (context bins, and terminates of value 0), from a 16-bit window."""
    n_bins = check_rows(data, sched, init, n_bins)
    dev = data.device
    R, nb = data.shape
    tab = cabac_tables(dev).long()
    rtab, tlps, tmps = tab[:256], tab[256:320], tab[320:]
    shift_tab = torch.from_numpy(_SHIFT).to(dev)
    d = torch.cat([data.long() & 0xFF,
                   torch.zeros((R, 1), dtype=torch.int64, device=dev)], 1)
    states = init.long().clone()
    s32 = lambda v: ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # noqa: E731
    b0 = d[:, 0]
    b1 = d[:, 1] if nb > 1 else torch.zeros_like(b0)
    off = ((b0 << 8) | b1) >> 7
    rng = torch.full((R,), 510, dtype=torch.int64, device=dev)
    pos = torch.full((R,), 9, dtype=torch.int64, device=dev)
    out = torch.zeros((R, n_bins), dtype=torch.int32, device=dev)
    for i in range(n_bins):
        kind = sched[:, i].long()
        is_ctx, is_byp, is_term = kind >= 0, kind == BYPASS, kind == TERMINATE
        # context-coded path, computed for every row as the JAX kernel
        # does; the state is written back only where the bin is one
        idx = kind.clamp(min=0)[:, None]
        s = states.gather(1, idx)[:, 0]
        p, mps = s >> 1, s & 1
        rlps = rtab[p * 4 + ((rng >> 6) & 3)]
        rng_c = rng - rlps
        lps = off >= rng_c
        bit_ctx = torch.where(lps, 1 - mps, mps)
        off_c = torch.where(lps, off - rng_c, off)
        rng_c = torch.where(lps, rlps, rng_c)
        mps_n = torch.where(lps & (p == 0), 1 - mps, mps)
        s_new = torch.where(lps, (tlps[p] << 1) | mps_n, (tmps[p] << 1) | mps)
        states.scatter_(1, idx, torch.where(is_ctx, s_new, s)[:, None])
        # terminate: range -= 2, no renormalisation when the bin is 1
        rng_t = rng - 2
        bit_term = (off >= rng_t).long()
        # renormalise (context, terminate 0) or read the bypass bit
        rng3 = torch.where(is_ctx, rng_c, torch.where(is_byp, rng, rng_t))
        renorm = is_ctx | (is_term & (bit_term == 0))
        n = torch.where(renorm, shift_tab[rng3.clamp(0, 511)], 0)
        n = torch.where(is_byp, 1, n)
        byte = (pos >> 3).clamp(max=nb)
        win = (d.gather(1, byte[:, None])[:, 0] << 8) \
            | d.gather(1, (byte + 1).clamp(max=nb)[:, None])[:, 0]
        bits = (win >> (16 - (pos & 7) - n)) & ((1 << n) - 1)
        pos = pos + n
        # bypass: the offset takes one bit before the compare
        off_b = s32((off << 1) | bits)
        bit_byp = (off_b >= rng).long()
        off_b = s32(off_b - bit_byp * rng)
        bit = torch.where(is_ctx, bit_ctx,
                          torch.where(is_byp, bit_byp, bit_term))
        out[:, i] = bit.int()
        off3 = torch.where(is_ctx, off_c, off)
        off = torch.where(is_byp, off_b, s32((off3 << n) | bits))
        rng = torch.where(is_byp, rng, rng3 << n)
    return out


def chain_bound(sched, smem_clocks: float, alu_clocks: float,
                clock_mhz: float, resident_rows: int) -> dict:
    """The least time the card could take for ``sched`` (int32 [R,
    n_bins], R >= 1), as the terms of the bound: a row is one dependent
    chain (bin i + 1 starts from the range and offset bin i leaves), so
    the set takes at least its longest row's chain, once for every
    ``resident_rows`` rows the card decodes at a time.  A bin's chain is
    ``CHAIN[kind]``: its shared-memory round trips at ``smem_clocks`` each
    and its dependent ALU instructions at ``alu_clocks`` each, at
    ``clock_mhz``.  Returns {"bins": (context, bypass, terminate) of the
    longest chain, "clocks": that chain, "waves", "ms"}."""
    s = sched.cpu()
    counts = torch.stack([(s >= 0).sum(1), (s == BYPASS).sum(1),
                          (s == TERMINATE).sum(1)], 1).double()
    clocks = counts @ torch.tensor(
        [n_smem * smem_clocks + n_alu * alu_clocks
         for n_smem, n_alu in CHAIN.values()], dtype=torch.float64)
    k = int(clocks.argmax())
    waves = -(-s.shape[0] // resident_rows)
    return {"bins": tuple(int(v) for v in counts[k]),
            "clocks": float(clocks[k]), "waves": waves,
            "ms": waves * float(clocks[k]) / (clock_mhz * 1e3)}


def decode_rows(data, sched, init, n_bins=None):
    """Decode R independent rows: bins int32 [R, n_bins].  CUDA tensors
    go through ``cabac_kernel`` (``cabac_cuda.py``), CPU tensors through
    ``decode_rows_plain``."""
    if data.device.type == "cpu":
        return decode_rows_plain(data, sched, init, n_bins)
    from .. import cabac_cuda
    n = check_rows(data, sched, init, n_bins)
    return cabac_cuda.launch_cabac(data.contiguous(), sched.contiguous(),
                                   init.contiguous(), n)


# ---------------------------------------------------------------------------
# capture of a stream's substreams
# ---------------------------------------------------------------------------

def capture_substreams(stream: bytes) -> List[Row]:
    """Decode ``stream`` with the Python syntax layer (``decoder/core.py``)
    and record every arithmetic engine it opens (one per slice segment,
    WPP row or tile), in the order they were opened: the bytes from the
    engine's start to its cursor after its last bin, its context states
    at its first context-coded bin, its schedule and the bins it decoded.
    Engines that decode no bin are left out.

    ``hevc_tpu_torch.decoder.core`` is patched for the decode and restored
    after it, also on failure: its ``CabacDecoder`` becomes a recording
    subclass, and the native slice and residual decoders are switched
    off, since both decode bins past the Python engine.  Raises on PCM
    (it leaves the arithmetic engine), on a row whose context bins use
    two state lists, and unless every frame's MD5 matches."""
    from ..decoder import core
    engines = []

    class Recording(CabacDecoder):
        def __init__(self, data, byte_offset=0):
            super().__init__(data, byte_offset)
            self.rec_start = byte_offset
            self.rec_states = self.rec_init = None
            self.rec_sched, self.rec_bins = [], []
            engines.append(self)

        def decode_bin(self, ctx):
            states, idx = ctx
            if self.rec_states is None:
                self.rec_states, self.rec_init = states, list(states)
            elif states is not self.rec_states:
                raise RuntimeError("capture_substreams: one engine decoded "
                                   "with two context state lists")
            b = super().decode_bin(ctx)
            self.rec_sched.append(idx)
            self.rec_bins.append(b)
            return b

        def decode_bypass(self):
            b = super().decode_bypass()
            self.rec_sched.append(BYPASS)
            self.rec_bins.append(b)
            return b

        def decode_terminate(self):
            b = super().decode_terminate()
            self.rec_sched.append(TERMINATE)
            self.rec_bins.append(b)
            return b

        def begin_pcm(self):
            raise RuntimeError("capture_substreams: PCM samples leave the "
                               "arithmetic engine; no schedule holds them")

    saved = (core.CabacDecoder, core._NATIVE_SLICE, core._NATIVE_RESIDUAL)
    core.CabacDecoder = Recording
    core._NATIVE_SLICE = core._NATIVE_RESIDUAL = False
    try:
        frames = core.Decoder(check_md5=True,
                              recon_backend="inline").decode_bytes(stream)
    finally:
        (core.CabacDecoder, core._NATIVE_SLICE,
         core._NATIVE_RESIDUAL) = saved
    bad = [f.poc for f in frames if f.md5_ok is not True]
    if not frames or bad:
        raise RuntimeError(f"capture_substreams: MD5 not ok for poc {bad} "
                           f"of {len(frames)} frames")
    return [Row(bytes(e.data[e.rec_start:e.bytes_consumed()]),
                e.rec_init or [0] * N_CTX, e.rec_sched, e.rec_bins)
            for e in engines if e.rec_sched]


# ---------------------------------------------------------------------------
# python -m hevc_tpu_torch.cabac.rows
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hevc_tpu_torch.cabac.rows")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        print("python -m hevc_tpu_torch.cabac.rows times the kernel and needs "
              "--device cuda", file=sys.stderr)
        return 2
    from .. import cabac_cuda
    t0 = time.perf_counter()
    rows = random_rows(np.random.default_rng(5), max(ROWS), N_BINS,
                       init_types=(0, 1, 2))
    print(f"encoded {len(rows)} rows of {N_BINS} bins in "
          f"{time.perf_counter() - t0:.1f} s")
    smem, alu = cabac_cuda.chain_latencies(dev)
    mhz, resident = max_sm_clock_mhz(), cabac_cuda.resident_rows(dev)
    print(f"chain bound from {smem:.2f} clocks a shared-memory round trip, "
          f"{alu:.2f} a dependent ALU instruction, {mhz:.0f} MHz, "
          f"{resident} rows at a time")
    for R in ROWS:
        data, sched, init, _ = (t.to(dev) for t in pack_rows(rows[:R]))
        got = decode_rows(data, sched, init)
        want = decode_rows_plain(data, sched, init)
        expected = torch.tensor([r.bins for r in rows[:R]],
                                dtype=torch.int32, device=dev)
        assert torch.equal(got, want), f"R={R}: kernel != plain"
        assert torch.equal(got, expected), f"R={R}: kernel != encoder bins"
        ms = cuda_ms(lambda: cabac_cuda.launch_cabac(data, sched, init,
                                                     N_BINS), iters=10)
        rate = R * N_BINS / ms / 1e3
        bound = chain_bound(sched, smem, alu, mhz, resident)
        print(f"R={R}: {rate:.3f} Mbins/s total ({rate / R:.4f} Mbins/s per "
              f"row, {ms:.4f} ms per launch, chain bound {bound['ms']:.4f} ms"
              f" for bins {bound['bins']}); kernel == plain == encoder")
    print(f"card: {torch.cuda.get_device_name(dev)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
