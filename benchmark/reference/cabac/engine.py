"""CABAC binary arithmetic codec — bit-exact H.265 clause 9.3.

Decoder follows the normative decoding process (9.3.4.3); encoder follows
the informative encoding process (9.3.4.4, PutBit/RenormE/FlushBits) so the
two are exact inverses. Capability parity with the reference's cabac.c /
cabac_functions.h engine (reference: libavcodec/cabac.c:177
ff_init_cabac_decoder, cabac_functions.h:107 get_cabac_inline) — this is a
re-derivation from the specification, not a port of the ffmpeg two-byte
lookahead engine.

Tables below are the standard's Table 9-46 (rangeTabLps) and Table 9-47
(transIdxLps/transIdxMps) — pure spec constants.

Frozen copy of ``hevc_tpu_torch/cabac/engine.py`` at ee5ffe9.
"""
from __future__ import annotations

# Table 9-46: rangeTabLps[pStateIdx][qRangeIdx]
RANGE_TAB_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85),
    (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62),
    (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45),
    (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33),
    (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24),
    (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18),
    (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13),
    (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2),
)

# Table 9-47
TRANS_IDX_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27,
    27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35,
    35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
)
TRANS_IDX_MPS = tuple(min(i + 1, 62) if i < 63 else 63 for i in range(64))


class CabacDecoder:
    """Arithmetic decoder over an RBSP byte buffer (bit position tracked)."""

    __slots__ = ("data", "bytepos", "nbytes", "range", "offset",
                 "_bitbuf", "_nbits")

    def __init__(self, data: bytes, byte_offset: int = 0):
        self.data = data
        self.bytepos = byte_offset
        self.nbytes = len(data)
        self.init()

    def init(self):
        """9.3.2.2 initialization: range=510, offset = 9 bits."""
        self.range = 510
        b0 = self._next_byte()
        b1 = self._next_byte()
        # 9 bits from the first two bytes; keep 7 spare bits in offset by
        # tracking offset at bit precision: we hold offset aligned to the
        # unread bit boundary.  Implementation: keep a bit-cursor.
        self._bitbuf = (b0 << 8) | b1
        self._nbits = 16
        self.offset = self._bitbuf >> 7
        self._bitbuf &= 0x7F
        self._nbits = 7

    # -- low-level bit feed ------------------------------------------------
    def _next_byte(self) -> int:
        if self.bytepos < self.nbytes:
            b = self.data[self.bytepos]
            self.bytepos += 1
            return b
        self.bytepos += 1
        return 0

    def _read_bit(self) -> int:
        if self._nbits == 0:
            self._bitbuf = self._next_byte()
            self._nbits = 8
        self._nbits -= 1
        return (self._bitbuf >> self._nbits) & 1

    # -- decode primitives ---------------------------------------------------
    def decode_bin(self, ctx) -> int:
        """Decode one context-coded bin; ctx is a ContextModel slot index
        pair (states list, idx)."""
        states, idx = ctx
        s = states[idx]
        p = s >> 1
        mps = s & 1
        rlps = RANGE_TAB_LPS[p][(self.range >> 6) & 3]
        self.range -= rlps
        if self.offset >= self.range:
            bit = 1 - mps
            self.offset -= self.range
            self.range = rlps
            if p == 0:
                mps = 1 - mps
            states[idx] = (TRANS_IDX_LPS[p] << 1) | mps
        else:
            bit = mps
            states[idx] = (TRANS_IDX_MPS[p] << 1) | mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return bit

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    def bytes_consumed(self) -> int:
        """Bytes consumed including partially-read byte."""
        return self.bytepos

    def begin_pcm(self) -> int:
        """After decode_terminate()==1 for pcm_flag: flush the engine
        (DecodeFlush, 9.3.4.3.4 — consumes 7 bits) and byte-align past
        the pcm_alignment_zero_bits.  Returns the byte offset in `data`
        where pcm_sample payload starts (reference semantics:
        cabac_functions.h skip_bytes + hevcdec.c hls_pcm_sample).

        The raw bits this decoder has pulled (9-bit init + 1 per renorm)
        exactly equal the bits the encoder emitted up to its terminate
        flush (10-bit flush minus the suppressed first bit), so the
        payload begins at the next byte boundary of the raw position."""
        pos = (8 * self.bytepos - self._nbits + 7) >> 3
        self._bitbuf = 0
        self._nbits = 0
        self.bytepos = pos
        return pos

    def reinit_at(self, byte_offset: int) -> None:
        """Re-initialize the arithmetic engine at a byte-aligned position
        (after pcm_sample data, 9.3.2.5).  Context states are untouched."""
        self.bytepos = byte_offset
        self.init()


class CabacEncoder:
    """Arithmetic encoder per the informative process of clause 9.3.4.4."""

    __slots__ = ("low", "range", "bits_outstanding", "first_bit", "_buf",
                 "_cur", "_ncur")

    def __init__(self):
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self._buf = bytearray()
        self._cur = 0
        self._ncur = 0

    # -- raw bit sink --------------------------------------------------------
    def _write_bit(self, b: int):
        self._cur = (self._cur << 1) | b
        self._ncur += 1
        if self._ncur == 8:
            self._buf.append(self._cur)
            self._cur = 0
            self._ncur = 0

    def _put_bit(self, b: int):
        if self.first_bit:
            self.first_bit = False
        else:
            self._write_bit(b)
        nb = 1 - b
        while self.bits_outstanding > 0:
            self._write_bit(nb)
            self.bits_outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low >= 256:
                if self.low >= 512:
                    self.low -= 512
                    self._put_bit(1)
                else:
                    self.low -= 256
                    self.bits_outstanding += 1
            else:
                self._put_bit(0)
            self.range <<= 1
            self.low <<= 1

    # -- encode primitives -----------------------------------------------------
    def encode_bin(self, ctx, bit: int):
        states, idx = ctx
        s = states[idx]
        p = s >> 1
        mps = s & 1
        rlps = RANGE_TAB_LPS[p][(self.range >> 6) & 3]
        self.range -= rlps
        if bit != mps:
            self.low += self.range
            self.range = rlps
            if p == 0:
                mps = 1 - mps
            states[idx] = (TRANS_IDX_LPS[p] << 1) | mps
        else:
            states[idx] = (TRANS_IDX_MPS[p] << 1) | mps
        self._renorm()

    def encode_bypass(self, bit: int):
        self.low <<= 1
        if bit:
            self.low += self.range
        if self.low >= 1024:
            self.low -= 1024
            self._put_bit(1)
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def encode_bypass_bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bit: int):
        self.range -= 2
        if bit:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self):
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        # write ((low>>7)&3)|1 as two bits — includes the rbsp stop bit
        v = ((self.low >> 7) & 3) | 1
        self._write_bit((v >> 1) & 1)
        self._write_bit(v & 1)

    def terminate_and_align(self) -> None:
        """After the final encode_terminate(1): byte-align with zeros."""
        while self._ncur:
            self._write_bit(0)

    def getvalue(self) -> bytes:
        if self._ncur:
            raise ValueError("CABAC payload not byte-aligned; call terminate_and_align")
        return bytes(self._buf)

    def align_before_reinit(self) -> None:
        """Byte-align (with zeros) between entropy segments (tiles/WPP rows
        share one buffer in a slice via entry points)."""
        while self._ncur:
            self._write_bit(0)

    def begin_pcm(self) -> None:
        """After encode_terminate(1) for pcm_flag: byte-align with zeros
        (the pcm_alignment_zero_bits)."""
        while self._ncur:
            self._write_bit(0)

    def write_raw(self, value: int, n: int) -> None:
        """Write n raw (non-arithmetic) bits — pcm_sample u(v) payload."""
        for i in range(n - 1, -1, -1):
            self._write_bit((value >> i) & 1)

    def restart(self) -> None:
        """Re-initialize the arithmetic engine after pcm_sample data
        (encoder mirror of 9.3.2.5; context states are untouched)."""
        if self._ncur:
            raise ValueError("PCM payload must leave the stream byte-aligned")
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
