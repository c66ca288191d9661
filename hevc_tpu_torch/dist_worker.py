"""One process of the banded decode across processes.

    python -m hevc_tpu_torch.dist_worker PORT RANK WORLD LOCAL_BANDS
        [--stream FILE] [--backend gloo|nccl] [--local-devices N]
        [--reps R]

Start it WORLD times, RANK 0 .. WORLD - 1, with one free TCP port on this
host.  Each process joins a ``torch.distributed`` group
(``tcp://localhost:PORT``; NCCL on the cards by default, gloo on the
CPU only when ``--backend gloo`` asks for it: with no card and no
``--backend`` it raises), owns LOCAL_BANDS consecutive column bands of
WORLD * LOCAL_BANDS, and runs ``sharded.decode_gop_banded`` over them,
the halos to the neighbouring ranks through ``batch_isend_irecv``.
Over NCCL rank RANK takes N consecutive cards (RANK * N .. RANK * N + N
- 1; N = 1 by default) and spreads its bands over them in contiguous
blocks; over gloo every band is on ``cpu``.  With R > 1 it decodes the
GOP R times and reports the best time (the set-up of the first decode
excluded).  The stream is FILE, an HEVC bitstream whose tile columns
are the WORLD * LOCAL_BANDS bands; without ``--stream`` every process
encodes the same
3-picture IPP stream (32 columns a band, 96 rows, QP 30, 32x32 CTBs, one
tile a band, deblocking and SAO).  Each packs only its own bands, checks
them against the same columns of the sequential host decode (every MD5 of
which must be correct) and prints ``worker <rank> OK decode_s=<seconds>``
(the best of the R decodes).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .band import prepare_gop_banded
from .sharded import BandLayout, decode_gop_banded, stitch


def _stream(n_bands):
    from .encoder.core import EncoderConfig, IntraEncoder
    from .encoder.generate import synth_frame
    w, h = 32 * n_bands, 96
    enc = IntraEncoder(EncoderConfig(
        width=w, height=h, qp=30, log2_ctb_size=5, log2_cu_size=5, gop="ipp",
        tiles=(n_bands, 1), deblocking=True, sao=True, seed=2,
        search_range=3))
    return b"".join(enc.encode_frame(synth_frame("noise", w, h, t, seed=4))
                    for t in range(3))


def _option(argv, name):
    """(the value of ``name`` or None, argv without it)."""
    if name not in argv:
        return None, argv
    i = argv.index(name)
    return argv[i + 1], argv[:i] + argv[i + 2:]


def main(argv):
    backend, argv = _option(argv, "--backend")
    path, argv = _option(argv, "--stream")
    n_dev, argv = _option(argv, "--local-devices")
    reps, argv = _option(argv, "--reps")
    n_dev, reps = int(n_dev or 1), int(reps or 1)
    port, rank, world, local = (argv[0], int(argv[1]), int(argv[2]),
                                int(argv[3]))
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dist_worker: no CUDA device is visible and no --backend was "
                "given; pass --backend gloo to run the bands on the CPU")
        backend = "nccl"
    if backend == "nccl":
        cards = [torch.device("cuda", rank * n_dev + j) for j in range(n_dev)]
        torch.cuda.set_device(cards[0])
    else:
        cards = [torch.device("cpu")] * n_dev
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        # a first operation every rank joins (NCCL leaves a first
        # batch_isend_irecv that not every rank joins undefined)
        dist.barrier()
        n_bands = world * local
        if path is None:
            stream = _stream(n_bands)
        else:
            with open(path, "rb") as f:
                stream = f.read()
        layout = BandLayout([cards[k * n_dev // local]
                             for k in range(local)], distributed=True)
        frames, ref_planes, (hl, hc) = prepare_gop_banded(
            stream, n_bands, bands=layout.bands)
        if not all(f["md5_ok"] for f in frames):
            raise RuntimeError("an MD5 of the sequential decode is wrong")
        if not any(pf.mc_groups for f in frames for pf in f["bands"].values()):
            raise RuntimeError("the stream has no inter content")
        decode_s = None
        for _rep in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            outs = decode_gop_banded(layout, frames, hl, hc)
            for dev in set(cards):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            decode_s = dt if decode_s is None else min(decode_s, dt)
        band_w = frames[0]["band_w"]
        sub = frames[0]["sub_w"]
        for i, (out, want) in enumerate(zip(outs, ref_planes)):
            for p, got in enumerate(stitch(out)):
                bw = band_w // (sub if p else 1)
                cols = want[p][:, layout.first * bw:
                               (layout.first + local) * bw]
                if not (got == cols).all():
                    y, x = np.argwhere(got != cols)[0]
                    raise AssertionError(
                        f"rank {rank}: picture {i} plane {p} differs first "
                        f"at (y, x) = ({y}, {x + layout.first * bw}): "
                        f"{got[y, x]} != {cols[y, x]}")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"worker {rank} OK decode_s={decode_s:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
