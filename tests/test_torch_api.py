"""The port's public API (``hevc_tpu_torch.api``, a copy of
``hevc_tpu.api`` whose handles decode with the port's frame program) and
its CLI's ``-b/--backend`` flag, on the CPU (``device="cpu"``), mirroring
tests/test_api.py, test_parser.py's AU feed and test_fixes_r2.py's
display-order pts."""
import numpy as np
import pytest
import torch

from hevc_tpu_torch import api, cli, native
from hevc_tpu_torch import log as ohlog
from hevc_tpu_torch.bitstream import nal as nalmod
from hevc_tpu_torch.decoder import Decoder
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder, RaEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.io.parser import split_access_units
from torch_gate import native_ready

pytestmark = pytest.mark.skipif(not native_ready(native),
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
    aus = _aus(frames=8, gop="ra")
    hdl = api.oh_init_lhvc(device=CPU)
    hdl.select_temporal_layer(0)
    hdl.start()
    got, _ = hdl.decode(b"".join(aus))
    # only temporal layer 0 decodes -> fewer frames than total
    n = (1 if got else 0) + len(hdl.close())
    assert 0 < n < 8


def test_lhvc_handle_returns_enhancement_layer_frames():
    """oh_init_lhvc decodes both layers of an SHVC stream and gives out the
    enhancement layer's pictures (beside a base-layer picture whose POC had
    no EL picture yet when it was bumped, as openhevc.c:553-562 selects),
    each with its MD5 true and equal to the inline decoder's."""
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
    got = [f for f in got if f.info.width == 96]
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
