"""MPEG-TS muxer + demuxer for a single HEVC elementary stream.

Capability parity with the reference's broadcast path (libavformat/
mpegts.c demuxer; stream_type 0x24 = HEVC per ISO/IEC 13818-1).  Built
from the TS packet grammar: 188-byte packets, PAT → PMT → PES
reassembly, adaptation-field stuffing; not a translation of mpegts.c.

Copied from ``hevc_tpu/io/mpegts.py`` at e99b487.
"""
from __future__ import annotations

import struct
from typing import List

TS_SIZE = 188
SYNC = 0x47
PAT_PID = 0x0000
PMT_PID = 0x1000
VIDEO_PID = 0x0100
STREAM_TYPE_HEVC = 0x24


def _crc32_mpeg(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000
                   else crc << 1) & 0xFFFFFFFF
    return crc


def _psi_packet(pid: int, table: bytes, cc: int) -> bytes:
    payload = b"\x00" + table  # pointer_field
    hdr = bytes([SYNC, 0x40 | (pid >> 8), pid & 0xFF, 0x10 | (cc & 0xF)])
    pkt = hdr + payload
    return pkt + b"\xff" * (TS_SIZE - len(pkt))


def _pat() -> bytes:
    body = struct.pack(">HBBB", 1, 0xC1, 0, 0)  # tsid, ver/cni, sec, last
    body += struct.pack(">HH", 1, 0xE000 | PMT_PID)  # program 1 -> PMT
    sec = bytes([0x00, 0xB0 | (len(body) + 4) >> 8,
                 (len(body) + 4) & 0xFF]) + body
    return sec + struct.pack(">I", _crc32_mpeg(sec))


def _pmt() -> bytes:
    es = bytes([STREAM_TYPE_HEVC, 0xE0 | (VIDEO_PID >> 8),
                VIDEO_PID & 0xFF, 0xF0, 0x00])
    body = struct.pack(">HBBB", 1, 0xC1, 0, 0)
    body += bytes([0xE0 | (VIDEO_PID >> 8), VIDEO_PID & 0xFF, 0xF0, 0x00])
    body += es
    sec = bytes([0x02, 0xB0 | (len(body) + 4) >> 8,
                 (len(body) + 4) & 0xFF]) + body
    return sec + struct.pack(">I", _crc32_mpeg(sec))


class TsWriter:
    """Mux Annex-B access units into a single-program transport stream."""

    def __init__(self, fps: int = 25):
        self.fps = fps
        self.aus: List[bytes] = []

    def add_au(self, annexb_au: bytes):
        self.aus.append(annexb_au)

    def getvalue(self) -> bytes:
        out = bytearray()
        out += _psi_packet(PAT_PID, _pat(), 0)
        out += _psi_packet(PMT_PID, _pmt(), 0)
        cc = 0
        for idx, au in enumerate(self.aus):
            pts = 90000 * idx // self.fps + 90000  # 90 kHz clock
            p = ((pts >> 30) & 7, (pts >> 15) & 0x7FFF, pts & 0x7FFF)
            pts_bytes = bytes([
                0x21 | (p[0] << 1),
                p[1] >> 7, ((p[1] & 0x7F) << 1) | 1,
                p[2] >> 7, ((p[2] & 0x7F) << 1) | 1])
            pes = (b"\x00\x00\x01\xe0" + struct.pack(">H", 0)
                   + bytes([0x80, 0x80, 5]) + pts_bytes + au)
            first = True
            i = 0
            while i < len(pes):
                chunk = pes[i:i + TS_SIZE - 4]
                i += len(chunk)
                flags2 = 0x10 | (cc & 0xF)
                hdr = bytes([SYNC,
                             (0x40 if first else 0) | (VIDEO_PID >> 8),
                             VIDEO_PID & 0xFF, flags2])
                cc += 1
                if len(chunk) < TS_SIZE - 4:
                    # stuff with an adaptation field
                    af_len = TS_SIZE - 4 - len(chunk) - 1
                    hdr = hdr[:3] + bytes([hdr[3] | 0x20])
                    af = bytes([af_len]) + (bytes([0x00])
                                            + b"\xff" * (af_len - 1)
                                            if af_len else b"")
                    out += hdr + af + chunk
                else:
                    out += hdr + chunk
                first = False
        return bytes(out)

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(self.getvalue())


class TsReader:
    """Demux the first HEVC PID of a transport stream → Annex-B bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.video_pid = None
        self._pes_chunks: List[bytes] = []
        self._parse()

    def _parse(self):
        data = self.data
        pmt_pid = None
        cur = bytearray()
        i = 0
        while i + TS_SIZE <= len(data):
            pkt = data[i:i + TS_SIZE]
            if pkt[0] != SYNC:
                # resync: realign the 188-byte grid to the next sync byte
                # whose following packet boundary also syncs
                j = data.find(bytes([SYNC]), i + 1)
                while 0 <= j and j + TS_SIZE < len(data) \
                        and data[j + TS_SIZE] != SYNC:
                    j = data.find(bytes([SYNC]), j + 1)
                if j < 0:
                    break
                i = j
                continue
            i += TS_SIZE
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            pusi = pkt[1] & 0x40
            afc = (pkt[3] >> 4) & 3
            p = 4
            if afc & 2:
                p += 1 + pkt[4]
            if not (afc & 1) or p >= TS_SIZE:
                continue
            payload = pkt[p:]
            if pid == PAT_PID and pmt_pid is None:
                sec = payload[1 + payload[0]:]
                # first program's PMT PID
                pmt_pid = ((sec[10] & 0x1F) << 8) | sec[11]
            elif pid == pmt_pid and self.video_pid is None:
                sec = payload[1 + payload[0]:]
                sec_len = ((sec[1] & 0x0F) << 8) | sec[2]
                pinfo_len = ((sec[10] & 0x0F) << 8) | sec[11]
                j = 12 + pinfo_len
                end = 3 + sec_len - 4
                while j + 5 <= end:
                    stype = sec[j]
                    epid = ((sec[j + 1] & 0x1F) << 8) | sec[j + 2]
                    eslen = ((sec[j + 3] & 0x0F) << 8) | sec[j + 4]
                    if stype == STREAM_TYPE_HEVC:
                        self.video_pid = epid
                        break
                    j += 5 + eslen
            elif pid == self.video_pid:
                if pusi:
                    if cur:
                        self._pes_chunks.append(bytes(cur))
                    cur = bytearray()
                cur += payload
        if cur:
            self._pes_chunks.append(bytes(cur))

    def annexb_stream(self) -> bytes:
        out = bytearray()
        for pes in self._pes_chunks:
            if pes[:3] != b"\x00\x00\x01":
                continue
            hdr_len = pes[8]
            out += pes[9 + hdr_len:]
        return bytes(out)
