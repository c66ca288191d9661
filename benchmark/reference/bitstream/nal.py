"""NAL unit framing: Annex-B split, emulation-prevention bytes (EPB).

Capability parity with the reference's h2645_parse.c (ff_h2645_packet_split
/ ff_h2645_extract_rbsp, reference: libavcodec/h2645_parse.c:32,249).
Re-derived from H.265 clause 7.3.1/7.4.1.  Like the reference we record the
positions of removed EPBs (`skipped_bytes_pos`) because WPP entry-point
offsets are expressed in pre-EPB-removal bytes and must be remapped
(reference: libavcodec/hevcdec.c:3355-3389).

Frozen copy of ``hevc_tpu_torch/bitstream/nal.py`` at ee5ffe9.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

# NAL unit types (H.265 Table 7-1)
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_STSA_N = 4
NAL_STSA_R = 5
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_BLA_W_RADL = 17
NAL_BLA_N_LP = 18
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA_NUT = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS_NUT = 36
NAL_EOB_NUT = 37
NAL_FD_NUT = 38
NAL_SEI_PREFIX = 39
NAL_SEI_SUFFIX = 40


def is_slice_nal(t: int) -> bool:
    return t <= NAL_CRA_NUT


def is_irap_nal(t: int) -> bool:
    return NAL_BLA_W_LP <= t <= NAL_CRA_NUT


def is_idr_nal(t: int) -> bool:
    return t in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


@dataclass
class NalUnit:
    type: int
    temporal_id: int  # TemporalId = nuh_temporal_id_plus1 - 1
    layer_id: int  # nuh_layer_id
    rbsp: bytes  # EPB-removed payload EXCLUDING the 2-byte NAL header
    skipped_bytes_pos: List[int] = field(default_factory=list)
    # byte offsets *within rbsp* at which an EPB was removed (position of
    # the byte following the removed 0x03, in post-removal coordinates)
    raw_size: int = 0  # size of the escaped payload incl. 2-byte header


def remove_epb(data: bytes):
    """Strip 00 00 03 emulation-prevention bytes.

    Returns (rbsp_bytes, skipped_positions) where skipped_positions[i] is
    the post-removal index of the byte that followed the removed 0x03.
    """
    out = bytearray()
    skipped = []
    i, n = 0, len(data)
    zeros = 0
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 <= n:
            # 0x03 only escapes if next byte is 00,01,02,03 (or end)
            if i + 1 == n or data[i + 1] <= 3:
                skipped.append(len(out))
                zeros = 0
                i += 1
                continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out), skipped


def insert_epb(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes into an RBSP payload."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _parse_nal(payload: bytes) -> NalUnit:
    if len(payload) < 2:
        raise ValueError("NAL unit too short")
    h0, h1 = payload[0], payload[1]
    if h0 & 0x80:
        raise ValueError("forbidden_zero_bit set")
    nal_type = (h0 >> 1) & 0x3F
    layer_id = ((h0 & 1) << 5) | (h1 >> 3)
    tid_plus1 = h1 & 7
    if tid_plus1 == 0:
        raise ValueError("nuh_temporal_id_plus1 == 0")
    rbsp, skipped = remove_epb(payload[2:])
    return NalUnit(
        type=nal_type,
        temporal_id=tid_plus1 - 1,
        layer_id=layer_id,
        rbsp=rbsp,
        skipped_bytes_pos=skipped,
        raw_size=len(payload),
    )


def split_annexb(data: bytes) -> List[NalUnit]:
    """Split an Annex-B byte stream into NAL units (start-code framed)."""
    nals = []
    n = len(data)
    i = data.find(b"\x00\x00\x01")
    if i < 0:
        return nals
    i += 3
    while i < n:
        nxt = data.find(b"\x00\x00\x01", i)
        if nxt < 0:
            end = n
        else:
            end = nxt
            # a 4-byte start code 00 00 00 01 owns its leading zero
            if end > i and data[end - 1] == 0:
                end -= 1
        payload = data[i:end]
        # strip trailing zero padding
        while payload and payload[-1] == 0:
            payload = payload[:-1]
        if payload:
            nals.append(_parse_nal(payload))
        if nxt < 0:
            break
        i = nxt + 3
    return nals


def write_nal_header(nal_type: int, layer_id: int = 0, temporal_id: int = 0) -> bytes:
    h0 = (nal_type << 1) | (layer_id >> 5)
    h1 = ((layer_id & 0x1F) << 3) | (temporal_id + 1)
    return bytes([h0, h1])


def write_annexb(nals) -> bytes:
    """Pack (nal_type, layer_id, temporal_id, rbsp) tuples into Annex-B."""
    out = bytearray()
    for nal_type, layer_id, temporal_id, rbsp in nals:
        out += b"\x00\x00\x00\x01"
        out += write_nal_header(nal_type, layer_id, temporal_id)
        out += insert_epb(rbsp)
    return bytes(out)
