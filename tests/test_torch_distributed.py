"""The banded decode across processes: two processes on the CPU joined by
``torch.distributed`` with gloo.

- the halo exchange of ``sharded._exchange`` across the ranks: each band
  gets its neighbours' edge columns, and the bands at the frame's edges
  get zeros;
- ``python -m hevc_tpu_torch.dist_worker`` with 2 ranks x 2 bands: each
  process packs and decodes its own two bands of a four-tile IPP stream
  and checks them against the same columns of the sequential decode (the
  counterpart of tests/test_distributed.py's banded decode);
- the same with 3 ranks x 1 band on a stream given as a file
  (``--stream``), so that the interior rank exchanges with two ranks;
- 2 ranks x 1 band of a stream with two slices a band, per-slice filter
  offsets, no loop filtering across tiles or one slice's edges, and PCM
  exempt from the filters: the offset, exemption and SAO restriction maps
  cross the ranks with the planes;
- with no ``--backend`` and no card the worker refuses to start: it never
  falls back to the CPU.

A worker that fails or outlives its time limit fails the test."""
import os
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HALO_WORKER = r"""
import sys
import torch
import torch.distributed as dist
from hevc_tpu_torch.sharded import BandLayout, _exchange

port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
layout = BandLayout(["cpu"] * 2, distributed=True)
n, w, hw = layout.n, 8, 3
assert layout.bands == range(2 * rank, 2 * rank + 2)


def band(k, dtype=torch.int32):
    return (1000 * (k + 1) + torch.arange(4 * w).view(4, w)).to(dtype)


fields = [([band(k) for k in layout.bands], hw),
          ([band(k, torch.int64) + 7 for k in layout.bands], 1)]
got = _exchange(layout, fields)
for f, (xs, width) in enumerate(fields):
    for i, k in enumerate(layout.bands):
        left, right = got[f][i]
        want_l = band(k - 1, xs[0].dtype)[:, w - width:] + 7 * f \
            if k > 0 else torch.zeros((4, width), dtype=xs[0].dtype)
        want_r = band(k + 1, xs[0].dtype)[:, :width] + 7 * f \
            if k < n - 1 else torch.zeros((4, width), dtype=xs[0].dtype)
        assert torch.equal(left, want_l), (rank, f, k, left, want_l)
        assert torch.equal(right, want_r), (rank, f, k, right, want_r)
dist.destroy_process_group()
print(f"worker {rank} OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(cmds, timeout):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for cmd in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"distributed workers outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
        assert f"worker {rank} OK" in out, out[-3000:]
    return outs


def test_two_process_halo_exchange_with_zeros_at_the_edges():
    port = _free_port()
    _run_workers([[sys.executable, "-c", HALO_WORKER, str(port), str(rank),
                   "2"] for rank in range(2)], timeout=120)


def test_two_process_banded_decode():
    port = _free_port()
    outs = _run_workers(
        [[sys.executable, "-m", "hevc_tpu_torch.dist_worker", str(port),
          str(rank), "2", "2", "--backend", "gloo"] for rank in range(2)],
        timeout=300)
    for rank, out in enumerate(outs):
        assert f"worker {rank} OK decode_s=" in out


def test_three_process_banded_decode_of_a_given_stream(tmp_path):
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=96, height=96, qp=30, log2_ctb_size=5, log2_cu_size=5,
        gop="ipp", tiles=(3, 1), deblocking=True, sao=True, seed=2,
        search_range=3))
    path = tmp_path / "tiles3.265"
    path.write_bytes(b"".join(enc.encode_frame(synth_frame(
        "noise", 96, 96, t, seed=4)) for t in range(3)))
    port = _free_port()
    outs = _run_workers(
        [[sys.executable, "-m", "hevc_tpu_torch.dist_worker", str(port),
          str(rank), "3", "1", "--stream", str(path), "--backend", "gloo"]
         for rank in range(3)], timeout=300)
    for rank, out in enumerate(outs):
        assert f"worker {rank} OK decode_s=" in out


def test_two_process_banded_decode_of_a_multislice_pcm_stream(tmp_path):
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=128, height=96, qp=30, log2_ctb_size=5, log2_cu_size=4,
        gop="ipp", tiles=(2, 2), slices=4, lf_across_tiles=False,
        slice_filter_params=(dict(beta_offset=2, tc_offset=-2),
                             dict(lf_across=False),
                             dict(beta_offset=-4, tc_offset=4),
                             dict(disable=True)),
        pcm=0.2, pcm_loop_filter_disabled=True, deblocking=True, sao=True,
        seed=2, search_range=3))
    path = tmp_path / "slices.265"
    path.write_bytes(b"".join(enc.encode_frame(synth_frame(
        "noise", 128, 96, t, seed=4)) for t in range(3)))
    port = _free_port()
    outs = _run_workers(
        [[sys.executable, "-m", "hevc_tpu_torch.dist_worker", str(port),
          str(rank), "2", "1", "--stream", str(path), "--backend", "gloo"]
         for rank in range(2)], timeout=300)
    for rank, out in enumerate(outs):
        assert f"worker {rank} OK decode_s=" in out


def test_dist_worker_without_a_backend_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the worker takes NCCL")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-m", "hevc_tpu_torch.dist_worker",
                        str(_free_port()), "0", "1", "1"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device is visible" in p.stderr \
        and "--backend gloo" in p.stderr, p.stderr[-2000:]
