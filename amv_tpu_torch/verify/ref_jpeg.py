"""The bit reader and writer of the progressive and lossless JPEG codecs:
the port's copy of what `bitstream/jpeg_progressive.py` and
`bitstream/jpeg_lossless.py` call in `amv_tpu/verify/ref_jpeg.py`.

* `unescape_scan`: the scan unescape (mjpegdec.c:1176-1199);
* `BitReader`: MSB first, 0 bits past the end, the JPEG extend read;
* `BitWriter` and `escape_ff`: the encoders' bit packing and 0xFF
  stuffing (mjpegenc.c escape_FF);
* `_read_vlc`: one Huffman symbol through a 16-bit-peek decode table
  (`codecs.jpeg_tables.build_decode_table`); an invalid code raises
  ValueError.
"""

from __future__ import annotations


def unescape_scan(data: bytes) -> bytes:
    """Remove 0x00 stuffing after 0xFF, keep RSTn markers in the stream,
    stop at any other real marker (mjpegdec.c:1176-1199: consecutive
    0xFFs collapse; FF 00 -> FF; FF D0-D7 passes through for the
    restart resync in the block decoder).  A real marker ends the scan
    before its preceding 0xFF (mjpegdec.c:1181 `t -= 2`), so the
    unescaped scan never carries a trailing marker prefix; a bare
    trailing 0xFF at the end of the data stays (no marker followed)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        x = data[i]
        i += 1
        out.append(x)
        if x == 0xFF:
            while i < n and data[i] == 0xFF:
                i += 1
            if i >= n:
                break
            x = data[i]
            i += 1
            if 0xD0 <= x <= 0xD7:
                out.append(x)
            elif x != 0:
                out.pop()  # real marker: its FF prefix isn't scan data
                break
    return bytes(out)


class BitReader:
    """MSB-first bit reader; reads past the end return 0 bits."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte_i = self.pos >> 3
            bit_i = 7 - (self.pos & 7)
            bit = (self.data[byte_i] >> bit_i) & 1 \
                if byte_i < len(self.data) else 0
            v = (v << 1) | bit
            self.pos += 1
        return v

    def get_xbits(self, n: int) -> int:
        """JPEG 'extend' read (bitstream.h get_xbits semantics)."""
        v = self.get_bits(n)
        if v < (1 << (n - 1)):
            return v - (1 << n) + 1
        return v


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put_bits(self, n: int, value: int):
        value &= (1 << n) - 1
        self.acc = (self.acc << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def bit_count(self):
        return len(self.buf) * 8 + self.nbits

    def flush(self) -> bytes:
        if self.nbits:
            raise ValueError("stuff to a byte boundary before flushing")
        return bytes(self.buf)


def escape_ff(scan: bytes) -> bytes:
    """0xFF -> 0xFF 0x00 in the entropy-coded segment (escape_FF)."""
    return scan.replace(b"\xFF", b"\xFF\x00")


def _read_vlc(br: BitReader, lut):
    lut_sym, lut_len = lut
    save = br.pos                      # peek 16 bits without consuming
    peek = br.get_bits(16)
    br.pos = save
    ln = int(lut_len[peek])
    if ln == 0:
        raise ValueError("invalid Huffman code")
    br.pos += ln
    return int(lut_sym[peek])
