"""The port's public API (``hevc_tpu_torch.api``, a copy of
``hevc_tpu.api`` whose handles decode with the port's frame program) and
its CLI's ``-b/--backend`` flag, on the CPU (``device="cpu"``), mirroring
tests/test_api.py, test_parser.py's AU feed and test_fixes_r2.py's
display-order pts."""
import numpy as np
import pytest
import torch

from hevc_tpu_torch import api, cli, native, pipeline
from hevc_tpu_torch import log as ohlog
from hevc_tpu_torch.bitstream import nal as nalmod
from hevc_tpu_torch.decoder import Decoder
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder, RaEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.io.parser import split_access_units

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")
CPU = "cpu"


def _aus(w=64, h=64, frames=4, **kw):
    enc = IntraEncoder(EncoderConfig(width=w, height=h, qp=30, **kw))
    return [enc.encode_frame(synth_frame("gradient", w, h, t))
            for t in range(frames)]


def test_handle_decodes_with_the_frame_program_on_the_device():
    hdl = api.oh_init(device=CPU)
    hdl.start()
    assert hdl._dec.recon_backend == "torch"
    assert hdl._dec.device.type == "cpu"
    # with no device named, the handle decodes on the card
    if torch.cuda.is_available():
        hdl = api.oh_init()
        hdl.start()
        assert hdl._dec.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            api.oh_init().start()


def test_lifecycle_per_au():
    hdl = api.oh_init(device=CPU)
    hdl.enable_sei_checksum(True)
    hdl.start()
    got_any = []
    for i, au in enumerate(_aus()):
        got, frm = hdl.decode(au, pts=1000 * i)
        if got:
            got_any.append(frm)
    got_any += hdl.close()
    assert len(got_any) == 4
    for i, frm in enumerate(got_any):
        assert frm.md5_ok
        assert frm.info.width == 64 and frm.info.height == 64
        assert frm.info.bit_depth == 8 and frm.info.chroma_format == 1
        assert frm.info.pts == 1000 * i
        assert frm.info.display_picture_number == i


def test_extradata_hvcc_and_annexb():
    from hevc_tpu_torch.io.mp4 import build_hvcc

    aus = _aus(frames=2)
    ps, rest0 = [], []
    for n in nalmod.split_annexb(aus[0]):
        tup = (n.type, n.layer_id, n.temporal_id, n.rbsp)
        (ps if n.type in (nalmod.NAL_VPS, nalmod.NAL_SPS, nalmod.NAL_PPS)
         else rest0).append(tup)
    ps_annexb = nalmod.write_annexb(ps)
    body0 = nalmod.write_annexb(rest0)

    for extradata in (ps_annexb, build_hvcc(ps_annexb)):
        hdl = api.oh_init(device=CPU)
        hdl.enable_sei_checksum(True)
        hdl.start()
        hdl.extradata_cpy(extradata)
        frames = []
        for au in (body0, aus[1]):
            got, frm = hdl.decode(au)
            if got:
                frames.append(frm)
        frames += hdl.close()
        assert len(frames) == 2 and all(f.md5_ok for f in frames)


def test_temporal_selection():
    """A hierarchical-B stream (temporal ids 0-2) in one call: temporal
    layer 0 alone decodes fewer pictures than the whole stream's 8."""
    enc = RaEncoder(EncoderConfig(width=64, height=64, qp=30, gop="ra",
                                  search_range=2))
    stream = bytes(enc.encode([synth_frame("gradient", 64, 64, t)
                               for t in range(8)]))

    def count(tid):
        hdl = api.oh_init_lhvc(device=CPU)
        hdl.select_temporal_layer(tid)
        hdl.start()
        got, _ = hdl.decode(stream)
        return (1 if got else 0) + len(hdl.close())

    # only temporal layer 0 decodes -> fewer frames than total
    assert 0 < count(0) < count(7) == 8


def test_lhvc_handle_returns_enhancement_layer_frames():
    """oh_init_lhvc decodes both layers of an SHVC stream and gives out the
    enhancement layer's pictures alone, each with its MD5 true and equal
    to the inline decoder's."""
    from torch_streams import shvc_stream
    data = shvc_stream("x1_5")
    want = [f for f in Decoder(check_md5=True).decode_bytes(data)
            if f.layer == 1]
    hdl = api.oh_init_lhvc(device=CPU)
    hdl.enable_sei_checksum(True)
    hdl.start()
    got = []
    for ret in [hdl.decode(data)] + [(True, f) for f in hdl.close()]:
        if ret[0]:
            assert ret[1].md5_ok is True
            got.append(ret[1])
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.md5_ok is True
        assert (a.info.width, a.info.height) == (96, 96)
        for pa, pb in zip(a.planes, b.planes):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))


def test_log_control():
    seen = []
    api.OHHandle.set_log_callback(lambda lvl, msg: seen.append((lvl, msg)))
    api.OHHandle.set_log_level(ohlog.OH_LOG_VERBOSE)
    try:
        api.oh_init(device=CPU).start()
        assert seen and seen[-1][0] == ohlog.OH_LOG_VERBOSE
        assert "backend=torch" in seen[-1][1]
    finally:
        api.OHHandle.set_log_callback(None)
        api.OHHandle.set_log_level(ohlog.OH_LOG_INFO)


def _stream(gop="ipp", n=4):
    cfg = EncoderConfig(width=96, height=64, qp=30, log2_ctb_size=5,
                        log2_cu_size=5, seed=3, gop=gop, search_range=2,
                        deblocking=True, sao=True)
    frames = [synth_frame("noise", 96, 64, t, seed=6) for t in range(n)]
    if gop == "ra":
        return bytes(RaEncoder(cfg).encode(frames))
    enc = IntraEncoder(cfg)
    return b"".join(enc.encode_frame(f) for f in frames)


def test_api_au_feed():
    """The handle consumes parsed AUs like oh_decode packets and gives the
    inline decoder's pictures."""
    stream = _stream()
    want = [[np.asarray(p) for p in f.planes]
            for f in Decoder(check_md5=True).decode_bytes(stream)]
    h = api.OHHandle(device=CPU)
    h.enable_sei_checksum(True)
    h.start()
    got = []

    def grab(ret):
        ok, fr = ret
        if ok:
            assert fr.md5_ok
            got.append([np.asarray(p).copy() for p in fr.planes])
        return ok

    for au in split_access_units(stream):
        grab(h.decode(au))
    while grab(h.decode(None)):
        pass
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for pa, pb in zip(a, b):
            assert np.array_equal(pa, pb)


def test_the_handle_keeps_only_pending_pack_jobs():
    """Fed one access unit a call, each picture read as it comes, a handle
    lets go of a finished pack job's future (and the device output it
    holds) at the next submit, rather than at ``flush``."""
    h = api.oh_init(device=CPU)
    h.start()
    kept = []
    for pts, au in enumerate(split_access_units(_stream(n=12))):
        ok, fr = h.decode(au, pts)
        if ok:
            np.asarray(fr.planes[0])
        kept.append(len(h._dec._pack_futs))
    h.close()
    assert len(kept) == 12 and max(kept) <= 4


def test_a_failed_pack_job_raises_at_the_next_submit():
    import concurrent.futures
    dec = Decoder(recon_backend="torch", device=CPU)
    try:
        concurrent.futures.wait([dec._pack_submit(lambda: 1 // 0)])
        with pytest.raises(ZeroDivisionError):
            dec._pack_submit(int)
        assert not dec._pack_futs
        dec.flush()  # raised once, not again
    finally:
        dec.close()


def test_pts_follows_picture_in_display_order():
    """With a reordering RA GOP, each output picture carries the pts of
    its own AU."""
    enc = RaEncoder(EncoderConfig(width=64, height=64, qp=30, gop="ra",
                                  search_range=2))
    n = 5
    stream = enc.encode([synth_frame("gradient", 64, 64, t)
                         for t in range(n)])
    aus = split_access_units(stream)
    assert len(aus) == n
    dec = Decoder()
    poc_of_au = []
    for au in aus:
        for nl in nalmod.split_annexb(au):
            dec.decode_nal(nl)
        poc_of_au.append(dec.layers[0].cur_poc)
    h = api.oh_init(device=CPU)
    h.start()
    outs = []
    for i, au in enumerate(aus):
        got, f = h.decode(au, pts=1000 + i)
        if got:
            outs.append(f)
    outs.extend(h.close())
    assert len(outs) == n
    order = sorted(range(n), key=lambda i: poc_of_au[i])
    assert [f.info.pts for f in outs] == [1000 + i for i in order]
    assert order != list(range(n))


@pytest.mark.parametrize("backend", ["torch", "inline", "plan"])
def test_cli_backend_flag(backend, tmp_path, capsys):
    path = tmp_path / "s.265"
    path.write_bytes(_stream(n=3))
    out = tmp_path / "o.yuv"
    rc = cli.main(["-i", str(path), "-o", str(out), "-b", backend,
                   "--device", CPU, "-v", "40"])
    text = capsys.readouterr().out
    assert rc == 0 and text.count("Correct MD5") == 3
    assert "frame= 3 " in text
    want = b"".join(np.asarray(p).astype(np.uint8).tobytes()
                    for f in Decoder(check_md5=True)
                    .decode_bytes(path.read_bytes()) for p in f.planes)
    assert out.read_bytes() == want


# ---- output selection of a layered handle, one access unit a call ---------

SHVC_AUS = 4


@pytest.fixture(scope="module")
def shvc_aus():
    """A 192x96 over 128x64 (x1.5) two-layer IPP stream as the SHVC cell
    has it (WPP, deblocking, SAO, the EL's TMVP from the inter-layer
    reference), split into access units."""
    from torch_streams import shvc_configs

    from hevc_tpu_torch.encoder.shvc import ShvcEncoder
    bl, el = shvc_configs((128, 64), (192, 96))
    for c in (bl, el):
        c.deblocking = c.sao = c.wpp = c.tmvp = True
    el.tmvp_col_ref_idx = 1
    enc = ShvcEncoder(bl, el)
    src = [synth_frame("gradient", w, h, 0) for w, h in ((128, 64),
                                                         (192, 96))]
    return [enc.encode_frame(*[[np.roll(p, (t, t), (0, 1)) for p in f]
                               for f in src]) for t in range(SHVC_AUS)]


def _feed(aus, layer=None, pts0=100, checksum=True):
    """One access unit a call through ``oh_init_lhvc`` (active layer
    ``layer``, or the default), the pictures of every call, then close's;
    returns (frames, the api_layer_* counters)."""
    from hevc_tpu_torch import trace
    trace.reset()
    h = api.oh_init_lhvc(device=CPU)
    if layer is not None:
        h.select_active_layer(layer)
    h.enable_sei_checksum(checksum)
    h.start()
    out = []
    for i, au in enumerate(aus):
        got, f = h.decode(au, pts=pts0 + i)
        if got:
            out.append(f)
    out += h.close()
    rep = trace.report()
    return out, {k: rep.get(k, {}).get("total", 0)
                 for k in ("api_layer_held", "api_layer_dropped")}


def _inline(aus, layer):
    return [f for f in Decoder(check_md5=True).decode_bytes(b"".join(aus))
            if f.layer == layer]


def _same_pictures(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.md5_ok is True
        for pa, pb in zip(a.planes, b.planes):
            assert np.array_equal(np.asarray(pa), np.asarray(pb))


def test_lhvc_handle_gives_one_picture_an_access_unit(shvc_aus):
    """Active layer 1: one picture an access unit, the EL's, in display
    order with its own pts, the last at close; each base-layer picture is
    held across its call and dropped once its EL picture is decoded."""
    got, counts = _feed(shvc_aus)
    assert [f.info.pts for f in got] == [100 + i for i in range(SHVC_AUS)]
    assert all((f.info.width, f.info.height) == (192, 96) for f in got)
    assert [f.info.display_picture_number for f in got] == \
        list(range(SHVC_AUS))
    _same_pictures(got, _inline(shvc_aus, 1))
    assert counts == {"api_layer_held": SHVC_AUS,
                      "api_layer_dropped": SHVC_AUS}


def test_lhvc_handle_on_the_base_layer_gives_base_pictures(shvc_aus):
    got, counts = _feed(shvc_aus, layer=0)
    assert [f.info.pts for f in got] == [100 + i for i in range(SHVC_AUS)]
    assert all((f.info.width, f.info.height) == (128, 64) for f in got)
    _same_pictures(got, _inline(shvc_aus, 0))
    assert counts == {"api_layer_held": 0, "api_layer_dropped": 0}


def test_an_access_unit_without_its_upper_layer_gives_its_base(shvc_aus):
    """The last access unit's EL picture left out: its base-layer picture
    comes out at close, after the EL pictures of the others (it was
    never held across a call: it finishes at close)."""
    last = nalmod.write_annexb([
        (n.type, n.layer_id, n.temporal_id, n.rbsp)
        for n in nalmod.split_annexb(shvc_aus[-1]) if n.layer_id == 0])
    got, counts = _feed(list(shvc_aus[:-1]) + [last])
    assert [f.info.pts for f in got] == [100 + i for i in range(SHVC_AUS)]
    assert [f.info.width for f in got] == [192] * (SHVC_AUS - 1) + [128]
    assert counts == {"api_layer_held": SHVC_AUS - 1,
                      "api_layer_dropped": SHVC_AUS - 1}


@pytest.mark.parametrize("checksum", [False, True],
                         ids=["checksum_off", "checksum_on"])
def test_a_dropped_base_picture_is_never_fetched(shvc_aus, monkeypatch,
                                                 checksum):
    """No base-layer picture's planes are copied out, for the output nor
    for the SEI checksum (the EL's are, as the API's caller reads them)."""
    fetched = []
    orig = pipeline.LazyPlanes._mat

    def mat(self):
        planes = orig(self)
        if self._dtype is None:  # an output or checksum copy, not the DPB's
            fetched.append(planes[0].shape[1])
        return planes

    monkeypatch.setattr(pipeline.LazyPlanes, "_mat", mat)
    got, _ = _feed(shvc_aus, checksum=checksum)
    assert len(got) == SHVC_AUS and set(fetched) == {192}
    assert all(f.md5_ok is (True if checksum else None) for f in got)


def test_the_cli_writes_pictures_of_one_size(shvc_aus, tmp_path):
    """An access unit without its EL picture: the CLI writes the EL's
    pictures alone (the API would deliver that unit's base picture)."""
    last = nalmod.write_annexb([
        (n.type, n.layer_id, n.temporal_id, n.rbsp)
        for n in nalmod.split_annexb(shvc_aus[-1]) if n.layer_id == 0])
    src, yuv = tmp_path / "s.265", tmp_path / "o.yuv"
    src.write_bytes(b"".join(list(shvc_aus[:-1]) + [last]))
    assert cli.main(["-i", str(src), "-o", str(yuv), "--device", CPU]) == 0
    assert yuv.stat().st_size == (SHVC_AUS - 1) * 192 * 96 * 3 // 2


def test_a_single_layer_handle_gives_every_picture_as_it_did():
    """``oh_init``: one access unit a call and the whole stream in one
    call give the decoder's pictures, in its order; no selection counts."""
    from hevc_tpu_torch import trace
    stream = _stream(gop="ra", n=6)
    want = Decoder(check_md5=True).decode_bytes(stream)
    trace.reset()
    for feed in (split_access_units(stream), [stream]):
        h = api.oh_init(device=CPU)
        h.enable_sei_checksum(True)
        h.start()
        got = []
        for i, au in enumerate(feed):
            ok, f = h.decode(au, pts=i)
            if ok:
                got.append(f)
        got += h.close()
        _same_pictures(got, want)
    assert "api_layer_held" not in trace.report()
    assert "api_layer_dropped" not in trace.report()


def _per_call_collect(self):
    """The selection before it was made per access unit: the highest
    layer of each POC among one call's pictures."""
    frames, self._dec.frames = self._dec.frames, []
    by_poc = {}
    for f in frames:
        cur = by_poc.get(f.poc)
        if cur is None or f.layer > cur.layer:
            by_poc[f.poc] = f
    for poc in sorted(by_poc):
        self._out_fifo.append(self._wrap(by_poc[poc]))


@pytest.mark.parametrize("per_call", [False, True],
                         ids=["per_access_unit", "per_call_guard"])
def test_the_benchmark_program_meets_the_reference(shvc_aus, per_call,
                                                   monkeypatch):
    """The benchmark's adapter (``benchmark.program``) on the two-layer
    stream, judged by ``benchmark.check`` against ``benchmark.reference``'s
    layer-1 decode: every picture right and none missing; under the old
    per-call selection pictures go missing."""
    from benchmark import check, refcache
    from benchmark.program import Program
    if per_call:
        monkeypatch.setattr(api.OHHandle, "_collect", _per_call_collect)
    prog = Program(2, CPU)
    pics = []
    for i, au in enumerate(shvc_aus):
        pics += prog.decode(au, i)
    pics += prog.close()
    delivered = {}
    for pts, planes, bd in pics:
        delivered.setdefault(pts, []).append(check.plane_digests(planes, bd))
    ref = {0: refcache.segment_digests(list(shvc_aus), 1)}
    numbers, _ = check.judge([(0, i) for i in range(SHVC_AUS)], delivered,
                             ref)
    if per_call:
        assert numbers["pictures_missing"] > 0
    else:
        assert numbers == {"planes_wrong": 0, "pictures_missing": 0}


def test_the_cli_trace_carries_the_shvc_spans_and_counters(shvc_aus,
                                                          tmp_path):
    """``cli --trace-out`` on the two-layer stream: the inter-layer spans
    (``il_motion`` a profiler range of the caller's thread), the selection
    counters as counter events, and the EL's pictures written."""
    import json
    src, out, yuv = (tmp_path / "s.265", tmp_path / "t.json",
                     tmp_path / "o.yuv")
    src.write_bytes(b"".join(shvc_aus))
    assert cli.main(["-i", str(src), "-o", str(yuv), "--device", CPU,
                     "--trace-out", str(out)]) == 0
    assert yuv.stat().st_size == SHVC_AUS * 192 * 96 * 3 // 2
    events = json.loads(out.read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"il_motion", "il_upsample", "il_pad"} <= spans
    counters = {e["name"]: e["args"][e["name"]] for e in events
                if e.get("ph") == "C"}
    assert counters["api_layer_held"] == SHVC_AUS
    assert counters["api_layer_dropped"] == SHVC_AUS
