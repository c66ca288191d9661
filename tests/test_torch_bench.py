"""``python -m hevc_tpu_torch.bench`` on the CPU, at tiny sizes.

Every section runs through the functions of the real configurations on
128x64-class streams with ``device="cpu"`` (the kernels' plain versions):
the port's stream generator against the root ``bench.py``'s, byte for byte;
each section's keys; the stage-B replay against the decode; the JSON line
of ``main`` with every time null; the work counts of ``bounds`` against a
NumPy recount; the decoder's worker threads shut down after a decode that
returns or raises; ``dist_worker`` with its bands over two devices and
``--reps``; and the bench's imports.
"""
import ast
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import bench as jax_bench
from hevc_tpu_torch import bench as B
from hevc_tpu_torch import pipeline
from hevc_tpu_torch.bounds import (STAGE_B_TERMS, loop_filter_work, mc_work,
                                   resid_work, stage_b_work)
from hevc_tpu_torch.capture import StageInputs
from hevc_tpu_torch.decoder import Decoder
from hevc_tpu_torch.mc_cuda import mc_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

TINY = {
    "tiny": B.Frames(B.Stream("t_128x64", 128, 64, 30, 3, True), "tiny",
                     iters=2, link=True, headline=True),
    "tiny_stages": B.Stages(B.Stream("t_128x64_nowpp", 128, 64, 30, 3,
                                     False), "tiny720", iters=2),
    "tiny_multihost": B.Multihost(B.TileStream("t_128x64_t2", 128, 64, 32,
                                               2, 2)),
    "tiny_shvc": B.Shvc(B.ShvcPair("t_shvc2", "t_shvc1", (64, 64),
                                   (128, 128), 2)),
}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny configurations, their streams encoded into a cache of
    their own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(B, "CACHE", str(tmp_path_factory.mktemp("bench")))
        for name, cfg in TINY.items():
            mp.setitem(B.CONFIGS, name, cfg)
        B.ensure_streams([j for c in TINY.values() for j in c.jobs()])
        yield TINY


@pytest.mark.parametrize("kind", ["gradient", "noise"])
def test_port_stream_is_bench_py_stream(tmp_path, kind):
    ours, theirs = tmp_path / "ours.265", tmp_path / "theirs.265"
    B._synth_stream(str(ours), 128, 64, 30, 2, True, kind)
    jax_bench._synth_stream(str(theirs), 128, 64, 30, 2, True, kind)
    assert ours.read_bytes() == theirs.read_bytes()


def test_e2e_section_checks_every_md5(tiny):
    out = B.bench_e2e(tiny["tiny"].stream.path, CPU)
    assert out["frames"] == 3 and len(out["runs"]) == B.RUNS
    assert out["fps"] in out["runs"]
    # the MD5 check fetches every picture's planes: the fetch span
    assert "fetch" in out["split"] and "pack_native" in out["split"]


def test_compute_section_keeps_outputs_on_the_device(tiny):
    out = B.bench_compute(tiny["tiny"].stream.path, CPU)
    assert out["frames"] == 3 and len(out["runs"]) == B.RUNS


def test_stage_b_replay_equals_the_decode_on_every_replay(tiny):
    rep, args, fps = B.bench_device_stage_b(tiny["tiny"].stream.path, CPU,
                                            3, "tiny")
    assert fps is None and rep.count == 3
    frames = Decoder(recon_backend="inline").decode_bytes(
        open(tiny["tiny"].stream.path, "rb").read())
    last_p = frames[-1]
    n = sum(p.size for p in map(np.asarray, last_p.planes))
    assert rep.want.numel() == n
    outs = rep.run(2)
    assert all(torch.equal(o, rep.want) for o in outs)
    rep.want = rep.want.clone()
    rep.want[0] += 1
    with pytest.raises(RuntimeError, match="differs from the decode"):
        rep.run(1)


def test_stage_b_work_names_each_term(tiny):
    _rep, args, _fps = B.bench_device_stage_b(tiny["tiny"].stream.path,
                                              CPU, 1, "tiny")
    work = stage_b_work(args)
    assert set(work) == set(STAGE_B_TERMS)
    assert all(work[k][0] > 0 for k in ("mc", "resid_add", "deblock", "sao",
                                        "output", "residuals", "upload"))
    assert work["mc"][1] > 0 and work["resid_add"][1] > 0
    S = dict(args[10])
    regions = S["regions"][:1] if S["mono"] else S["regions"]
    lf = loop_filter_work([(h, w) for _oy, _ox, h, w in regions],
                          S["h4"], S["w4"], S["ctb_h"], S["ctb_w"],
                          S["do_deblock"], S["do_sao"], S["per_slice"],
                          S["nf"])
    assert work["sao"][0] == lf["sao"]
    assert work["deblock"][0] == lf["deblock_v"] + lf["deblock_h"]
    assert work["deblock"][1] == work["sao"][1] == 0
    mc_args, ra_args = _p_frame_inputs(tiny["tiny"].stream.path)
    canvas, refs_l, refs_c, groups, _bd = mc_args
    assert work["mc"] == mc_work(refs_l, refs_c, mc_table(groups,
                                                          canvas.shape))
    assert work["resid_add"] == resid_work(ra_args[1], ra_args[2])


STAGE_KEYS = {"dequant_idct", "mc", "resid_add", "intra_wavefront",
              "deblock", "sao"}


def test_stages_section_records_every_stage(tiny):
    rep, out = B.bench_stages(tiny["tiny_stages"], CPU)
    assert out["kernel_max_abs_err"] == {"mc": 0, "resid_add": 0}
    assert set(out["kernel_bound_us"]) == {f"{k}_tiny720"
                                           for k in STAGE_KEYS}
    assert out["kernel_us"] is None and out["kernel_gbps"] is None
    assert out["stageB_replay_fps_tiny720"] is None
    assert rep.count == out["stageB_replays_tiny720"] == 2


def test_shvc_section(tiny):
    out = B.bench_shvc(tiny["tiny_shvc"], CPU)
    assert set(out) == {"shvc_2layer_s", "shvc_el_only_s",
                        "shvc_2layer_vs_el_only", "shvc_2layer_s_runs",
                        "shvc_el_only_s_runs"}
    assert len(out["shvc_2layer_s_runs"]) == B.RUNS


def test_multihost_section_one_process_against_two_over_gloo(tiny):
    out = B.bench_multihost(tiny["tiny_multihost"], CPU)
    assert out["multihost_decode_s_1host"] > 0
    assert out["multihost_decode_s_2host"] > 0
    assert "1proc x 2 bands" in out["multihost_geometry"]
    assert "2proc x 1 bands" in out["multihost_geometry"]


TIME_KEYS = ("oracle_fps", "compute_fps", "compute_vs_oracle", "e2e_fps",
             "stage_ms_per_frame", "stageB_replay_fps", "d2h_ms_per_frame",
             "d2h_pinned_ms_per_frame", "h2d_ms_per_frame", "link_MBps",
             "link_flagged", "link_rolling_median_MBps", "device_stageB",
             "device_idle_share", "section_s", "kernel_us", "kernel_gbps",
             "shvc_2layer_s", "shvc_el_only_s", "shvc_2layer_vs_el_only",
             "multihost_scaling_efficiency", "multihost_decode_s",
             "stageB_tiny720_device_fps")


def _main_json(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = B.main(argv)
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1])


def test_main_prints_one_json_line_with_every_time_null(tiny):
    got = _main_json(["--device", "cpu", "--config", "tiny", "--config",
                      "tiny_stages"])
    assert got["metric"] == "e2e_decode_fps_128x64_wpp_ipp"
    assert got["value"] is None and got["vs_baseline"] is None
    assert got["unit"] == "fps"
    assert got["device"] == {"name": "cpu", "power_limit": None, "count": 0}
    extra = got["extra"]
    want = {
        "oracle_fps", "compute_fps_tiny", "compute_fps_tiny_runs",
        "compute_vs_oracle_tiny", "e2e_fps_tiny", "e2e_fps_tiny_runs",
        "md5_ok_tiny", "frames_tiny", "stage_ms_per_frame",
        "stageB_replay_fps_tiny", "stageB_replays_tiny",
        "stageB_bytes_per_frame_tiny", "stageB_bytes_terms_tiny",
        "stageB_bytes_vs_min_tiny", "d2h_ms_per_frame_tiny",
        "d2h_pinned_ms_per_frame_tiny", "h2d_ms_per_frame_tiny",
        "link_MBps", "link_flagged", "link_rolling_median_MBps",
        "device_stageB_fps_tiny", "device_stageB_busy_ms_tiny",
        "device_idle_share_tiny", "device_stageB_vs_oracle_tiny",
        "kernel_max_abs_err", "kernel_bytes", "kernel_bound_us",
        "kernel_bound_by", "kernel_us", "kernel_gbps",
        "stageB_replay_fps_tiny720", "stageB_replays_tiny720",
        "device_stageB_fps_tiny720", "device_stageB_busy_ms_tiny720",
        "device_idle_share_tiny720", "stageB_tiny720_device_fps",
        "section_s"}
    assert set(extra) == want
    for k, v in extra.items():
        if k.startswith(TIME_KEYS):
            assert v is None, k
    assert extra["md5_ok_tiny"] is True and extra["frames_tiny"] == 3
    assert extra["stageB_replays_tiny"] == 2
    assert extra["kernel_max_abs_err"] == {"mc": 0, "resid_add": 0}
    assert extra["stageB_bytes_per_frame_tiny"] > 0


def test_main_with_multihost_and_shvc_names_their_keys(tiny):
    extra = _main_json(["--device", "cpu", "--config", "tiny_multihost",
                        "--config", "tiny_shvc"])["extra"]
    assert set(extra) == {
        "multihost_scaling_efficiency", "multihost_geometry",
        "multihost_decode_s_1host", "multihost_decode_s_2host",
        "multihost_cards", "shvc_2layer_s", "shvc_el_only_s",
        "shvc_2layer_vs_el_only", "shvc_2layer_s_runs",
        "shvc_el_only_s_runs", "section_s"}
    assert all(v is None for k, v in extra.items()
               if k.startswith(TIME_KEYS))


def test_main_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert B.main([]) != 0
    assert "CUDA is not available" in capsys.readouterr().err


def _p_frame_inputs(path):
    """The mc and resid_add inputs of the stream's last P picture."""
    args, _want = B.capture_frame_program(open(path, "rb").read(), CPU)
    rec = StageInputs()
    with rec.installed():
        pipeline.frame_program(*args)
    return rec.calls["mc"][1], rec.calls["resid_add"][1]


def test_mc_and_resid_work_match_a_numpy_recount(tiny):
    (canvas, refs_l, refs_c, groups, _bd), (_c, fields, pools, _b) = \
        _p_frame_inputs(tiny["tiny"].stream.path)
    table = mc_table(groups, canvas.shape)
    got_b, got_ops = mc_work(refs_l, refs_c, table)
    seen, ops, px = {False: set(), True: set()}, 0, 0
    for is_ch, bi, _wp, w, h, start, n in table.groups:
        nt = 4 if is_ch else 8
        c = nt // 2 - 1
        nr, hp, wp = (refs_c if is_ch else refs_l).shape
        for row in table.rows[start:start + n].astype(np.int64):
            px += w * h
            ops += 4 * w * h
            for o in ((0, 5) if bi else (0,)):
                sel = min(max(row[o], 0), nr - 1)
                by = min(max(row[o + 1], 0), hp - (h + nt - 1))
                bx = min(max(row[o + 2], 0), wp - (w + nt - 1))
                fx, fy = row[o + 3] != 0, row[o + 4] != 0
                ys = range(h + nt - 1) if fy else range(c, c + h)
                xs = range(w + nt - 1) if fx else range(c, c + w)
                seen[bool(is_ch)] |= {(sel, by + y, bx + x)
                                      for y in ys for x in xs}
                ops += 2 * nt * w * ((h + nt - 1) * fx + h * fy)
    want_b = 4 * (len(seen[False]) + len(seen[True]) + px) \
        + table.rows.nbytes
    assert (got_b, got_ops) == (want_b, ops) and px > 0
    want_b = want_ops = 0
    for k, f in enumerate(fields):
        f = f.numpy()
        s = 4 << k
        slots = np.unique(np.clip(f[:, 2], 0, pools[k].shape[0] - 1))
        want_b += 8 * len(f) * s * s + 4 * len(slots) * s * s + 12 * len(f)
        want_ops += 3 * len(f) * s * s
    assert resid_work(fields, pools) == (want_b, want_ops) and want_b > 0


def test_stage_b_work_counts_a_coo_upload(tmp_path):
    """A P picture whose level pool ships as (idx, val) pairs (a smooth
    256x192 picture): ``stage_b_work``'s upload counts the pairs (6 bytes
    each) and the scatter's write of the dense int16 pool, not the dense
    upload; the residual stage reads the dense pool.  NumPy recount."""
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=256, height=192, qp=30, gop="ipp", deblocking=True, sao=True,
        log2_ctb_size=5, log2_cu_size=5, search_range=2, seed=1))
    path = tmp_path / "coo.265"
    path.write_bytes(b"".join(enc.encode_frame(synth_frame(
        "gradient", 256, 192, t, seed=3)) for t in range(2)))
    args, _want = B.capture_frame_program(path.read_bytes(), CPU)
    meta, meta16, meta8, avail, levels = args[:5]
    S = dict(args[10])
    coo_n, total = S["coo"]
    assert coo_n > 0 and S["n_refs"], S["coo"]
    idx, val = levels
    sizes = [4 << c for c in range(4)]
    assert total == sum(n * s * s for n, s in zip(S["nlv"], sizes))
    _s, rmeta, _f, groups = pipeline.host_views(meta, meta16, S)
    rows = mc_table(groups, args[6] if isinstance(args[6], tuple)
                    else args[6].shape).rows
    work = stage_b_work(args)
    assert work["upload"][0] == (meta.nbytes + meta8.nbytes + avail.nbytes
                                 + idx.nbytes + val.nbytes + 2 * total
                                 + rows.nbytes)
    assert idx.nbytes + val.nbytes == 6 * coo_n < 2 * total
    pool_px = sum((n + 1) * s * s for n, s in zip(S["nlv"], sizes))
    assert work["residuals"][0] == 2 * total + 36 * sum(S["nlv"]) \
        + 4 * pool_px


def _plan_raising(n):
    def hook(pic, plan, dpb):
        hook.calls += 1
        if hook.calls == n:
            raise RuntimeError("second picture")
    hook.calls = 0
    return hook


@pytest.mark.parametrize("backend", ["plan", "torch"])
@pytest.mark.parametrize("raises", [False, True])
def test_decoder_leaves_no_thread_behind(tiny, monkeypatch, backend,
                                         raises):
    data = open(tiny["tiny"].stream.path, "rb").read()
    before = set(threading.enumerate())
    kw = {}
    if raises and backend == "plan":
        kw["plan_hook"] = _plan_raising(2)
    elif raises:
        orig = pipeline.finish_frame
        calls = []

        def finish(*a):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("second picture")
            return orig(*a)
        monkeypatch.setattr(pipeline, "finish_frame", finish)
    if backend == "torch":
        kw["device"] = CPU
    dec = Decoder(recon_backend=backend, **kw)
    if raises:
        with pytest.raises(RuntimeError, match="second picture"):
            dec.decode_bytes(data)
    else:
        frames = dec.decode_bytes(data)
        assert [f.md5_ok for f in frames] == [True] * 3
        assert all(np.asarray(f.planes[0]).shape == (64, 128)
                   for f in frames)
    assert set(threading.enumerate()) <= before


def test_dist_worker_spreads_its_bands_over_devices_with_reps(tiny):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    r = subprocess.run(
        [sys.executable, "-m", "hevc_tpu_torch.dist_worker", str(port), "0",
         "1", "2", "--stream", tiny["tiny_multihost"].stream.path,
         "--backend", "gloo", "--local-devices", "2", "--reps", "2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "worker 0 OK decode_s=" in r.stdout


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_bench_imports_neither_jax_nor_hevc_tpu_nor_bench_py():
    path = os.path.join(ROOT, "hevc_tpu_torch", "bench.py")
    assert not set(_imported_roots(path)) & {"jax", "hevc_tpu", "bench"}
