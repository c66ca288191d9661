"""Minimal ISO-BMFF (MP4/MOV) demuxer + muxer for HEVC tracks.

Capability parity with the reference's MOV demuxer path (libavformat/mov.c
+ the hvcC extradata decode in libavcodec/hevcdec.c:4100
hevc_decode_extradata): extract the `hvcC` decoder configuration record
(ISO/IEC 14496-15 §8.3.3.1) and the length-prefixed samples, convert both
to Annex-B.  The muxer writes the inverse: one sample per access unit,
4-byte length prefixes, parameter sets carried in hvcC.

This is a ground-up implementation from the ISO-BMFF box grammar — not a
translation of mov.c (which is ~7 kLoC of general-purpose demuxing).

Copied from ``hevc_tpu/io/mp4.py`` at e99b487.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..bitstream import nal as nalmod


# ---------------------------------------------------------------- hvcC ----

@dataclass
class HvcC:
    """HEVCDecoderConfigurationRecord."""
    profile_space: int = 0
    tier_flag: int = 0
    profile_idc: int = 1
    compat_flags: int = 1 << 30
    constraint_flags: int = 0
    level_idc: int = 63
    chroma_format_idc: int = 1
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    length_size: int = 4  # NALU length prefix bytes
    num_temporal_layers: int = 1
    temporal_id_nested: int = 1
    # nal_type -> list of raw NAL payloads (header + escaped payload)
    arrays: Dict[int, List[bytes]] = field(default_factory=dict)

    def param_set_nals(self) -> List[nalmod.NalUnit]:
        """All parameter-set/SEI NALs carried in the record, parse order
        VPS, SPS, PPS, SEI (mirrors hevc_decode_extradata feeding them
        through the normal NAL path)."""
        out = []
        for t in sorted(self.arrays):
            for raw in self.arrays[t]:
                out += nalmod.split_annexb(b"\x00\x00\x01" + raw)
        return out


def build_hvcc(annexb_ps: bytes, length_size: int = 4) -> bytes:
    """Build an hvcC record from an Annex-B chunk holding VPS/SPS/PPS
    (+optional prefix SEI).  Profile/level fields are read from the SPS."""
    from ..bitstream.ps import SPS

    arrays: Dict[int, List[bytes]] = {}
    sps = None
    for n in nalmod.split_annexb(annexb_ps):
        raw = (nalmod.write_nal_header(n.type, n.layer_id, n.temporal_id)
               + nalmod.insert_epb(n.rbsp))
        arrays.setdefault(n.type, []).append(raw)
        if n.type == nalmod.NAL_SPS and sps is None:
            sps = SPS.parse_rbsp(n.rbsp)
    assert sps is not None, "hvcC needs an SPS"
    ptl = sps.ptl
    rec = bytearray()
    rec.append(1)  # configurationVersion
    rec.append((ptl.profile_space << 6) | (ptl.tier_flag << 5)
               | ptl.profile_idc)
    rec += struct.pack(">I", ptl.compat_flags)
    rec += (0).to_bytes(6, "big")  # constraint flags
    rec.append(ptl.level_idc)
    rec += struct.pack(">H", 0xF000)  # min_spatial_segmentation_idc
    rec.append(0xFC)  # parallelismType = 0 (unknown)
    rec.append(0xFC | sps.chroma_format_idc)
    rec.append(0xF8 | (sps.bit_depth_luma - 8))
    rec.append(0xF8 | (sps.bit_depth_chroma - 8))
    rec += struct.pack(">H", 0)  # avgFrameRate
    rec.append((0 << 6) | (1 << 3) | (1 << 2) | (length_size - 1))
    order = [t for t in (nalmod.NAL_VPS, nalmod.NAL_SPS, nalmod.NAL_PPS,
                         nalmod.NAL_SEI_PREFIX) if t in arrays]
    rec.append(len(order))
    for t in order:
        rec.append(0x80 | t)  # array_completeness=1
        rec += struct.pack(">H", len(arrays[t]))
        for raw in arrays[t]:
            rec += struct.pack(">H", len(raw)) + raw
    return bytes(rec)


def parse_hvcc(data: bytes) -> HvcC:
    r = HvcC()
    assert data[0] == 1, "unsupported hvcC version"
    r.profile_space = data[1] >> 6
    r.tier_flag = (data[1] >> 5) & 1
    r.profile_idc = data[1] & 0x1F
    r.compat_flags = struct.unpack(">I", data[2:6])[0]
    r.constraint_flags = int.from_bytes(data[6:12], "big")
    r.level_idc = data[12]
    # 13-14 min_spatial_segmentation, 15 parallelismType
    r.chroma_format_idc = data[16] & 3
    r.bit_depth_luma = (data[17] & 7) + 8
    r.bit_depth_chroma = (data[18] & 7) + 8
    # 19-20 avgFrameRate
    b = data[21]
    r.num_temporal_layers = (b >> 3) & 7
    r.temporal_id_nested = (b >> 2) & 1
    r.length_size = (b & 3) + 1
    i = 23
    for _ in range(data[22]):
        t = data[i] & 0x3F
        (cnt,) = struct.unpack(">H", data[i + 1:i + 3])
        i += 3
        for _ in range(cnt):
            (ln,) = struct.unpack(">H", data[i:i + 2])
            r.arrays.setdefault(t, []).append(data[i + 2:i + 2 + ln])
            i += 2 + ln
    return r


def lengths_to_annexb(sample: bytes, length_size: int = 4) -> bytes:
    """Convert one length-prefixed sample to Annex-B."""
    out = bytearray()
    i, n = 0, len(sample)
    while i + length_size <= n:
        ln = int.from_bytes(sample[i:i + length_size], "big")
        i += length_size
        out += b"\x00\x00\x00\x01" + sample[i:i + ln]
        i += ln
    return bytes(out)


def annexb_to_lengths(au: bytes, length_size: int = 4) -> bytes:
    out = bytearray()
    for n in nalmod.split_annexb(au):
        raw = (nalmod.write_nal_header(n.type, n.layer_id, n.temporal_id)
               + nalmod.insert_epb(n.rbsp))
        out += len(raw).to_bytes(length_size, "big") + raw
    return bytes(out)


# ------------------------------------------------------------- box I/O ----

def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">B", version)
                + flags.to_bytes(3, "big") + payload)


def _walk(data: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_end) for sibling boxes."""
    i = start
    while i + 8 <= end:
        (size,) = struct.unpack(">I", data[i:i + 4])
        fourcc = data[i + 4:i + 8]
        hdr = 8
        if size == 1:
            (size,) = struct.unpack(">Q", data[i + 8:i + 16])
            hdr = 16
        elif size == 0:
            size = end - i
        yield fourcc, i + hdr, i + size
        i += size


def _find(data: bytes, start: int, end: int, path: List[bytes]):
    """Find the first box at the given nested path; returns (s, e)."""
    for fourcc, s, e in _walk(data, start, end):
        if fourcc == path[0]:
            if len(path) == 1:
                return s, e
            # skip FullBox headers / fixed prefixes of container-ish boxes
            off = {b"stsd": 8, b"mp4a": 28}.get(path[1], 0)
            return _find(data, s + off, e, path[1:])
    return None


class Mp4Writer:
    """One-video-track MP4 muxer: hvc1 sample entry, one AU per sample.

    Capability mirror of what the reference consumes via mov.c; layout is
    ftyp + mdat + moov (samples flushed before the index, stco absolute)."""

    def __init__(self, width: int, height: int, timescale: int = 25,
                 sample_duration: int = 1):
        self.width, self.height = width, height
        self.timescale, self.dur = timescale, sample_duration
        self.samples: List[bytes] = []
        self.ps_annexb = b""

    def add_parameter_sets(self, annexb: bytes):
        self.ps_annexb += annexb

    def add_au(self, annexb_au: bytes):
        """Add one access unit.  Parameter-set NALs are hoisted to hvcC."""
        ps, rest = [], []
        for n in nalmod.split_annexb(annexb_au):
            tup = (n.type, n.layer_id, n.temporal_id, n.rbsp)
            if n.type in (nalmod.NAL_VPS, nalmod.NAL_SPS, nalmod.NAL_PPS):
                ps.append(tup)
            else:
                rest.append(tup)
        if ps:
            self.ps_annexb += nalmod.write_annexb(ps)
        self.samples.append(annexb_to_lengths(nalmod.write_annexb(rest)))

    def getvalue(self) -> bytes:
        ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512)
                    + b"isomiso2mp41")
        mdat_payload = b"".join(self.samples)
        mdat_off = len(ftyp) + 8
        mdat = _box(b"mdat", mdat_payload)

        n = len(self.samples)
        hvcc = build_hvcc(self.ps_annexb)
        hvc1 = _box(b"hvc1", struct.pack(">6xH", 1)  # data_reference_index
                    + b"\x00" * 16
                    + struct.pack(">HH", self.width, self.height)
                    + struct.pack(">II", 0x480000, 0x480000)
                    + b"\x00" * 4 + struct.pack(">H", 1)
                    + b"\x00" * 32
                    + struct.pack(">Hh", 0x18, -1)
                    + _box(b"hvcC", hvcc))
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + hvc1)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.dur))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n)
                     + b"".join(struct.pack(">I", len(s))
                                for s in self.samples))
        stco = _full(b"stco", 0, 0, struct.pack(">II", 1, mdat_off))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
        url = _full(b"url ", 0, 1, b"")
        dinf = _box(b"dinf", _full(b"dref", 0, 0,
                                   struct.pack(">I", 1) + url))
        vmhd = _full(b"vmhd", 0, 1, b"\x00" * 8)
        minf = _box(b"minf", vmhd + dinf + stbl)
        hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4 + b"vide" + b"\x00" * 12
                     + b"VideoHandler\x00")
        dur = n * self.dur
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0,
                                                self.timescale, dur,
                                                0x55C4, 0))
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full(b"tkhd", 0, 7, struct.pack(">IIIII", 0, 0, 1, 0, dur)
                     + b"\x00" * 16
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0,
                                   0, 0, 0x40000000)
                     + struct.pack(">II", self.width << 16,
                                   self.height << 16))
        trak = _box(b"trak", tkhd + mdia)
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0,
                                                self.timescale, dur)
                     + struct.pack(">IH2x8x", 0x10000, 0x100)
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0,
                                   0, 0, 0x40000000)
                     + b"\x00" * 24 + struct.pack(">I", 2))
        moov = _box(b"moov", mvhd + trak)
        return ftyp + mdat + moov

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(self.getvalue())


class Mp4Reader:
    """Demux the first HEVC video track: hvcC + samples → Annex-B AUs."""

    def __init__(self, data: bytes):
        self.data = data
        self.hvcc: Optional[HvcC] = None
        self._parse()

    def _parse(self):
        data = self.data
        moov = _find(data, 0, len(data), [b"moov"])
        assert moov, "no moov box"
        stbl = None
        for fourcc, s, e in _walk(data, *moov):
            if fourcc != b"trak":
                continue
            found = _find(data, s, e, [b"mdia", b"minf", b"stbl"])
            if not found:
                continue
            entry = _find(data, found[0], found[1], [b"stsd"])
            body = data[entry[0] + 8:entry[1]]
            if body[4:8] in (b"hvc1", b"hev1"):
                stbl = found
                # hvcC lives inside the sample entry after the 78-byte
                # VisualSampleEntry prefix
                se_start = entry[0] + 8 + 8  # stsd entry header + box hdr
                cfg = _find(data, se_start + 78, entry[1], [b"hvcC"])
                assert cfg, "no hvcC in sample entry"
                self.hvcc = parse_hvcc(data[cfg[0]:cfg[1]])
                break
        assert stbl, "no HEVC track"
        s, e = stbl
        boxes = {fourcc: (bs, be) for fourcc, bs, be in _walk(data, s, e)}

        def full_payload(name):
            bs, be = boxes[name]
            return data[bs + 4:be]  # skip FullBox version/flags

        sz = full_payload(b"stsz")
        fixed, count = struct.unpack(">II", sz[:8])
        sizes = ([fixed] * count if fixed else
                 list(struct.unpack(f">{count}I", sz[8:8 + 4 * count])))
        if b"stco" in boxes:
            co = full_payload(b"stco")
            (nch,) = struct.unpack(">I", co[:4])
            chunks = list(struct.unpack(f">{nch}I", co[4:4 + 4 * nch]))
        else:
            co = full_payload(b"co64")
            (nch,) = struct.unpack(">I", co[:4])
            chunks = list(struct.unpack(f">{nch}Q", co[4:4 + 8 * nch]))
        sc = full_payload(b"stsc")
        (nsc,) = struct.unpack(">I", sc[:4])
        stsc = [struct.unpack(">III", sc[4 + 12 * i:16 + 12 * i])
                for i in range(nsc)]
        # expand chunk map → per-sample file offsets
        self.samples: List[Tuple[int, int]] = []
        si = 0
        for ci in range(nch):
            per = next(spc for first, spc, _ in reversed(stsc)
                       if first <= ci + 1)
            off = chunks[ci]
            for _ in range(per):
                if si >= len(sizes):
                    break
                self.samples.append((off, sizes[si]))
                off += sizes[si]
                si += 1

    def annexb_stream(self) -> bytes:
        """Whole stream as Annex-B: parameter sets then every AU."""
        out = bytearray()
        for t in sorted(self.hvcc.arrays):
            for raw in self.hvcc.arrays[t]:
                out += b"\x00\x00\x00\x01" + raw
        ls = self.hvcc.length_size
        for off, size in self.samples:
            out += lengths_to_annexb(self.data[off:off + size], ls)
        return bytes(out)

    def access_units(self) -> List[bytes]:
        ls = self.hvcc.length_size
        return [lengths_to_annexb(self.data[o:o + s], ls)
                for o, s in self.samples]
