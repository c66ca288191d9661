"""SEI messages — decoded-picture-hash (MD5) is the correctness oracle.

Capability parity with the reference's hevc_sei.c (ff_hevc_decode_nal_sei
:347) and the MD5 verification in hevcdec.c verify_md5 (:4035).

Frozen copy of ``hevc_tpu_torch/bitstream/sei.py`` at ee5ffe9.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .bits import BitReader, BitWriter

SEI_TYPE_PICTURE_TIMING = 1
SEI_TYPE_USER_DATA_REGISTERED_ITU_T_T35 = 4
SEI_TYPE_USER_DATA_UNREGISTERED = 5
SEI_TYPE_FRAME_PACKING = 45
SEI_TYPE_DISPLAY_ORIENTATION = 47
SEI_TYPE_ACTIVE_PARAMETER_SETS = 129
SEI_TYPE_DECODED_PICTURE_HASH = 132
SEI_TYPE_MASTERING_DISPLAY_INFO = 137
SEI_TYPE_CONTENT_LIGHT_LEVEL = 144
SEI_TYPE_ALTERNATIVE_TRANSFER = 147


@dataclass
class DecodedPictureHash:
    hash_type: int = 0  # 0 = MD5
    md5: List[bytes] = field(default_factory=list)  # per plane, 16 bytes each

    def payload(self) -> bytes:
        assert self.hash_type == 0
        return bytes([0]) + b"".join(self.md5)

    @classmethod
    def parse(cls, data: bytes, num_planes: int = 0) -> "DecodedPictureHash":
        h = cls()
        h.hash_type = data[0]
        if h.hash_type == 0:
            # plane count from the payload length (1 for monochrome)
            n = num_planes or (len(data) - 1) // 16
            h.md5 = [data[1 + 16 * i:1 + 16 * (i + 1)] for i in range(n)]
        return h


@dataclass
class FramePacking:
    """Frame-packing arrangement SEI (payload type 45).

    Capability parity with hevc_sei.c decode_nal_sei_frame_packing_arrangement
    and its export as stereo-3D side data (hevcdec.c set_side_data)."""
    arrangement_id: int = 0
    cancel: int = 0
    arrangement_type: int = 3          # 3=side-by-side, 4=top-bottom, 5=temporal
    quincunx: int = 0
    content_interpretation: int = 1    # 1: frame0 = left view
    current_frame_is_frame0: int = 0

    def payload(self) -> bytes:
        w = BitWriter()
        w.ue(self.arrangement_id)
        w.flag(self.cancel)
        if not self.cancel:
            w.u(self.arrangement_type, 7)
            w.flag(self.quincunx)
            w.u(self.content_interpretation, 6)
            w.flag(0)  # spatial_flipping_flag
            w.flag(0)  # frame0_flipped_flag
            w.flag(0)  # field_views_flag
            w.flag(self.current_frame_is_frame0)
            w.flag(0)  # frame0_self_contained_flag
            w.flag(0)  # frame1_self_contained_flag
            if not self.quincunx and self.arrangement_type != 5:
                for _ in range(4):  # frame0/1 grid position x/y
                    w.u(0, 4)
            w.u(0, 8)  # frame_packing_arrangement_reserved_byte
            w.flag(1)  # persistence
        w.flag(0)      # upsampled_aspect_ratio_flag
        w.rbsp_trailing_bits()
        return w.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "FramePacking":
        r = BitReader(data)
        m = cls()
        m.arrangement_id = r.ue()
        m.cancel = r.flag()
        if not m.cancel:
            m.arrangement_type = r.u(7)
            m.quincunx = r.flag()
            m.content_interpretation = r.u(6)
            r.u(3)  # spatial_flipping, frame0_flipped, field_views
            m.current_frame_is_frame0 = r.flag()
            r.u(2)  # self-contained flags
            if not m.quincunx and m.arrangement_type != 5:
                r.u(16)
            r.u(8)
            r.flag()
        return m


@dataclass
class DisplayOrientation:
    """Display-orientation SEI (payload type 47); exported as a rotation/
    flip side item (reference: hevc_sei.c display-orientation parse +
    hevcdec.c display-matrix side data)."""
    cancel: int = 0
    hflip: int = 0
    vflip: int = 0
    anticlockwise_rotation: int = 0  # units of 2^-16 turns

    def payload(self) -> bytes:
        w = BitWriter()
        w.flag(self.cancel)
        if not self.cancel:
            w.flag(self.hflip)
            w.flag(self.vflip)
            w.u(self.anticlockwise_rotation, 16)
            w.flag(1)  # persistence
        w.rbsp_trailing_bits()
        return w.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "DisplayOrientation":
        r = BitReader(data)
        m = cls()
        m.cancel = r.flag()
        if not m.cancel:
            m.hflip = r.flag()
            m.vflip = r.flag()
            m.anticlockwise_rotation = r.u(16)
            r.flag()
        return m


@dataclass
class MasteringDisplay:
    """Mastering-display colour volume SEI (payload type 137)."""
    # (x, y) pairs in 0.00002 units, G/B/R order per spec
    primaries: tuple = ((0, 0), (0, 0), (0, 0))
    white_point: tuple = (0, 0)
    max_luminance: int = 0  # 0.0001 cd/m^2 units
    min_luminance: int = 0

    def payload(self) -> bytes:
        w = BitWriter()
        for x, y in self.primaries:
            w.u(x, 16)
            w.u(y, 16)
        w.u(self.white_point[0], 16)
        w.u(self.white_point[1], 16)
        w.u(self.max_luminance, 32)
        w.u(self.min_luminance, 32)
        return w.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "MasteringDisplay":
        r = BitReader(data)
        m = cls()
        m.primaries = tuple((r.u(16), r.u(16)) for _ in range(3))
        m.white_point = (r.u(16), r.u(16))
        m.max_luminance = r.u(32)
        m.min_luminance = r.u(32)
        return m


@dataclass
class ContentLightLevel:
    """Content light level SEI (payload type 144)."""
    max_content_light_level: int = 0
    max_pic_average_light_level: int = 0

    def payload(self) -> bytes:
        w = BitWriter()
        w.u(self.max_content_light_level, 16)
        w.u(self.max_pic_average_light_level, 16)
        return w.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "ContentLightLevel":
        r = BitReader(data)
        return cls(r.u(16), r.u(16))


@dataclass
class AlternativeTransfer:
    """Alternative transfer characteristics SEI (payload type 147)."""
    preferred_transfer_characteristics: int = 2

    def payload(self) -> bytes:
        return bytes([self.preferred_transfer_characteristics])

    @classmethod
    def parse(cls, data: bytes) -> "AlternativeTransfer":
        return cls(data[0])


@dataclass
class UserDataRegistered:
    """ITU-T T.35 registered user data (payload type 4).  A/53 closed
    captions are country 0xB5, provider 0x0031, id "GA94" — the reference
    exports those as A53_CC side data (hevc_sei.c registered-user-data)."""
    country_code: int = 0xB5
    provider_code: int = 0x0031
    data: bytes = b""

    @property
    def is_a53_cc(self) -> bool:
        return (self.country_code == 0xB5 and self.provider_code == 0x0031
                and self.data[:4] == b"GA94")

    def payload(self) -> bytes:
        out = bytearray()
        if self.country_code >= 0xFF:
            out += bytes([0xFF, self.country_code - 0xFF])
        else:
            out.append(self.country_code)
        out += self.provider_code.to_bytes(2, "big")
        out += self.data
        return bytes(out)

    @classmethod
    def parse(cls, data: bytes) -> "UserDataRegistered":
        m = cls()
        i = 1
        if data[0] == 0xFF:
            m.country_code = 0xFF + data[1]
            i = 2
        else:
            m.country_code = data[0]
        m.provider_code = int.from_bytes(data[i:i + 2], "big")
        m.data = data[i + 2:]
        return m


@dataclass
class ActiveParameterSets:
    """Active parameter sets SEI (payload type 129)."""
    active_vps_id: int = 0
    self_contained_cvs: int = 0
    no_parameter_set_update: int = 0
    active_sps_ids: tuple = (0,)

    def payload(self) -> bytes:
        w = BitWriter()
        w.u(self.active_vps_id, 4)
        w.flag(self.self_contained_cvs)
        w.flag(self.no_parameter_set_update)
        w.ue(len(self.active_sps_ids) - 1)
        for sid in self.active_sps_ids:
            w.ue(sid)
        w.rbsp_trailing_bits()
        return w.getvalue()

    @classmethod
    def parse(cls, data: bytes) -> "ActiveParameterSets":
        r = BitReader(data)
        m = cls()
        m.active_vps_id = r.u(4)
        m.self_contained_cvs = r.flag()
        m.no_parameter_set_update = r.flag()
        n = r.ue() + 1
        m.active_sps_ids = tuple(r.ue() for _ in range(n))
        return m


# side-data registry: payload type -> (key, parser)
SIDE_DATA_PARSERS = {
    SEI_TYPE_FRAME_PACKING: ("frame_packing", FramePacking.parse),
    SEI_TYPE_DISPLAY_ORIENTATION: ("display_orientation",
                                   DisplayOrientation.parse),
    SEI_TYPE_MASTERING_DISPLAY_INFO: ("mastering_display",
                                      MasteringDisplay.parse),
    SEI_TYPE_CONTENT_LIGHT_LEVEL: ("content_light", ContentLightLevel.parse),
    SEI_TYPE_ALTERNATIVE_TRANSFER: ("alternative_transfer",
                                    AlternativeTransfer.parse),
    SEI_TYPE_USER_DATA_REGISTERED_ITU_T_T35: ("user_data_registered",
                                              UserDataRegistered.parse),
    SEI_TYPE_ACTIVE_PARAMETER_SETS: ("active_parameter_sets",
                                     ActiveParameterSets.parse),
}


def plane_md5(plane: np.ndarray, bit_depth: int) -> bytes:
    """MD5 of one picture plane, matching the conformance convention:
    samples in raster order, little-endian, 1 byte if bit_depth<=8 else 2.
    (reference: libavcodec/hevcdec.c:4035-4098 verify_md5)"""
    if bit_depth <= 8:
        raw = plane.astype(np.uint8).tobytes()
    else:
        raw = plane.astype("<u2").tobytes()
    return hashlib.md5(raw).digest()


def picture_md5(planes, bit_depth: int) -> List[bytes]:
    return [plane_md5(p, bit_depth) for p in planes]


def write_sei_rbsp(messages) -> bytes:
    """messages: list of (payload_type, payload_bytes)."""
    out = bytearray()
    for ptype, payload in messages:
        t = ptype
        while t >= 255:
            out.append(255)
            t -= 255
        out.append(t)
        s = len(payload)
        while s >= 255:
            out.append(255)
            s -= 255
        out.append(s)
        out += payload
    out.append(0x80)  # rbsp_trailing_bits
    return bytes(out)


def parse_sei_rbsp(rbsp: bytes):
    """Yields (payload_type, payload_bytes) messages."""
    msgs = []
    i = 0
    n = len(rbsp)
    while i < n:
        # stop at rbsp trailing bits (0x80 possibly followed by zeros)
        if rbsp[i] == 0x80 and all(b == 0 for b in rbsp[i + 1:]):
            break
        ptype = 0
        while i < n and rbsp[i] == 255:
            ptype += 255
            i += 1
        ptype += rbsp[i]; i += 1
        size = 0
        while i < n and rbsp[i] == 255:
            size += 255
            i += 1
        size += rbsp[i]; i += 1
        msgs.append((ptype, rbsp[i:i + size]))
        i += size
    return msgs
