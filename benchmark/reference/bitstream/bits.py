"""MSB-first bit reader/writer with Exp-Golomb codes.

Capability parity with the reference's get_bits.h / golomb.c / put_bits
(reference: libavcodec/get_bits.h, libavcodec/golomb.c), re-implemented
from the H.265 spec's bit-parsing semantics (clause 9.2).

Frozen copy of ``hevc_tpu_torch/bitstream/bits.py`` at ee5ffe9.
"""
from __future__ import annotations


class BitReader:
    """Reads bits MSB-first from a bytes-like RBSP payload."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.nbits = 8 * len(data)

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def u(self, n: int) -> int:
        """Read n bits as an unsigned integer (f(n)/u(n) descriptor)."""
        if n == 0:
            return 0
        if self.pos + n > self.nbits:
            raise EOFError(f"bit overread: want {n} at {self.pos}/{self.nbits}")
        p, d = self.pos, self.data
        self.pos = p + n
        # byte-level extraction
        first_byte = p >> 3
        last_byte = (p + n - 1) >> 3
        chunk = int.from_bytes(d[first_byte:last_byte + 1], "big")
        tail = 7 - ((p + n - 1) & 7)
        return (chunk >> tail) & ((1 << n) - 1)

    def flag(self) -> int:
        return self.u(1)

    def ue(self) -> int:
        """Unsigned Exp-Golomb (ue(v))."""
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid exp-golomb code")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """Signed Exp-Golomb (se(v))."""
        k = self.ue()
        if k & 1:
            return (k + 1) >> 1
        return -(k >> 1)

    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP payload before the rbsp_stop_one_bit."""
        if self.pos >= self.nbits:
            return False
        # find last set bit in the stream (the stop bit)
        rem = self.nbits - self.pos
        # scan from the end for the final 1 bit
        for byte_idx in range(len(self.data) - 1, -1, -1):
            b = self.data[byte_idx]
            if b:
                # position of lowest set bit
                low = (b & -b).bit_length() - 1
                stop_pos = byte_idx * 8 + (7 - low)
                return self.pos < stop_pos
        return False

    def rbsp_trailing_bits(self) -> None:
        one = self.u(1)
        if one != 1:
            raise ValueError("rbsp_stop_one_bit != 1")
        while not self.byte_aligned():
            if self.u(1) != 0:
                raise ValueError("rbsp_alignment_zero_bit != 0")


class BitWriter:
    """Writes bits MSB-first; mirror of BitReader."""

    __slots__ = ("_buf", "_cur", "_ncur")

    def __init__(self):
        self._buf = bytearray()
        self._cur = 0
        self._ncur = 0

    @property
    def bit_position(self) -> int:
        return 8 * len(self._buf) + self._ncur

    def u(self, value: int, n: int) -> None:
        if n == 0:
            return
        if value < 0 or value >> n:
            raise ValueError(f"value {value} does not fit in {n} bits")
        cur, ncur = self._cur, self._ncur
        cur = (cur << n) | value
        ncur += n
        while ncur >= 8:
            ncur -= 8
            self._buf.append((cur >> ncur) & 0xFF)
        self._cur = cur & ((1 << ncur) - 1)
        self._ncur = ncur

    def flag(self, value) -> None:
        self.u(1 if value else 0, 1)

    def ue(self, value: int) -> None:
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        vp1 = value + 1
        nbits = vp1.bit_length()
        self.u(0, nbits - 1)
        self.u(vp1, nbits)

    def se(self, value: int) -> None:
        if value > 0:
            self.ue(2 * value - 1)
        else:
            self.ue(-2 * value)

    def byte_aligned(self) -> bool:
        return self._ncur == 0

    def rbsp_trailing_bits(self) -> None:
        self.u(1, 1)
        while not self.byte_aligned():
            self.u(0, 1)

    def align_zero(self) -> None:
        while not self.byte_aligned():
            self.u(0, 1)

    def align_zero_one(self) -> None:
        """alignment_bit_equal_to_one padding (vps_extension)."""
        while not self.byte_aligned():
            self.u(1, 1)

    def getvalue(self) -> bytes:
        if self._ncur:
            raise ValueError("bitstream not byte-aligned")
        return bytes(self._buf)
