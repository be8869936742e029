"""Fixed JPEG tables of the AMV (Sunplus sp5x) MJPEG variant.

The port's own copy of what it reads from `amv_tpu/bitstream/jpeg_tables.py`:

* zigzag scan order (libavcodec dsputil.c ff_zigzag_direct);
* the sp5x "Q60" quant pair the decoder uses (sp5x.h:187-195, index 5),
  zigzag order;
* the standard JPEG K.3 Huffman tables (mjpeg.c:65-126);
* the MPEG-1 default intra matrix, the basis of the encoder's quantizer
  (mpeg12data.c, applied at mpegvideo_enc.c:2866-2876);
* amvlib's own ~Q75 pair (`AMVLIB_QUANT_LUMA` / `_CHROMA`,
  AmvJpeg.c:30-61), for its decoder (`codecs/amvlib_video.py`);
* canonical code assignment and the flat 16-bit-peek decode table;
* the headers written with these tables: the K.3 DHT segment (`DHT_K3`),
  `canned_jpeg_header` (the one the reference's AMV decoder prepends,
  `amv_tpu/bitstream/jpeg_tables.py:canned_jpeg_header`) and the
  encoder's dequant matrix `encoder_quant_matrix` (the one an MJPEG header
  carries);

and the forms derived from them once, as numpy arrays, that the kernels
read (the wrappers copy them to a device once per device, `device_table`):

* `encoder_qmat(qscale)`: the encoder's reciprocal quantizer matrix
  (mpegvideo_enc.c ff_convert_matrix over the MPEG-1 intra matrix), raster
  order; the counterpart of `amv_tpu.codecs.amv_video._encoder_quant_qmat_np`;
* `Q60_LUMA` / `Q60_CHROMA`: the decoder's sp5x Q60 dequant tables, raster;
* Huffman tables, indexed DC-luma 0, DC-chroma 1, AC-luma 2, AC-chroma 3:
  `DEC_LUT` (flat 16-bit-peek table for the plain decoder), `RECORD_LUT`
  (the same with JAX's reading of an invalid code, for the plain record
  decoder), `DEC_FAST` and `REC_FAST` (their two-level forms for kernels
  D and R), `ENC_TABLES` (code and size per symbol).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels._build import device_key

ZIGZAG = np.array([
    0,   1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

SP5X_QUANT_LUMA_ZZ = np.array([
    13,  9, 10, 11, 10,  8, 13, 11, 10, 11, 14, 14, 13, 15, 19, 32,
    21, 19, 18, 18, 19, 39, 28, 30, 23, 32, 46, 41, 49, 48, 46, 41,
    45, 44, 51, 58, 74, 62, 51, 54, 70, 55, 44, 45, 64, 87, 65, 70,
    76, 78, 82, 83, 82, 50, 62, 90, 97, 90, 80, 96, 74, 81, 82, 79,
], dtype=np.int32)

SP5X_QUANT_CHROMA_ZZ = np.array([
    14, 14, 14, 19, 17, 19, 38, 21, 21, 38, 79, 53, 45, 53, 79, 79,
    79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79,
    79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79,
    79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79, 79,
], dtype=np.int32)

# ---------------------------------------------------------------------------
# Standard K.3 Huffman tables (mjpeg.c:65-126).
# bits[i] = number of codes of length i (1..16); vals = symbols in code order.
# ---------------------------------------------------------------------------
BITS_DC_LUMA = np.array(
    [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32)
VALS_DC_LUMA = np.arange(12, dtype=np.int32)

BITS_DC_CHROMA = np.array(
    [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], dtype=np.int32)
VALS_DC_CHROMA = np.arange(12, dtype=np.int32)

BITS_AC_LUMA = np.array(
    [0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], dtype=np.int32)
VALS_AC_LUMA = np.array([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
], dtype=np.int32)

BITS_AC_CHROMA = np.array(
    [0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], dtype=np.int32)
VALS_AC_CHROMA = np.array([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
], dtype=np.int32)

# ---------------------------------------------------------------------------
# MPEG-1 default intra matrix (raster order) -- basis of the AMV encoder's
# quantization matrix (mpegvideo_enc.c:2866-2876).
# ---------------------------------------------------------------------------
MPEG1_INTRA_MATRIX = np.array([
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
], dtype=np.int32)

# amvlib's fixed ~Q75 pair (C-AMVDecoder/amvlib/AmvJpeg.c:30-61), read by
# its own decoder (codecs/amvlib_video.py, kernel W) index for index
# against the zigzag-ordered levels.
AMVLIB_QUANT_LUMA = np.array([
    0x08, 0x06, 0x06, 0x07, 0x06, 0x05, 0x08, 0x07,
    0x07, 0x07, 0x09, 0x09, 0x08, 0x0A, 0x0C, 0x14,
    0x0D, 0x0C, 0x0B, 0x0B, 0x0C, 0x19, 0x12, 0x13,
    0x0F, 0x14, 0x1D, 0x1A, 0x1F, 0x1E, 0x1D, 0x1A,
    0x1C, 0x1C, 0x20, 0x24, 0x2E, 0x27, 0x20, 0x22,
    0x2C, 0x27, 0x1C, 0x1C, 0x28, 0x37, 0x29, 0x2C,
    0x30, 0x31, 0x34, 0x34, 0x34, 0x1F, 0x27, 0x39,
    0x3D, 0x38, 0x32, 0x3C, 0x2E, 0x33, 0x34, 0x32,
], dtype=np.int32)

AMVLIB_QUANT_CHROMA = np.array(
    [0x09, 0x09, 0x09, 0x0C, 0x0B, 0x0C, 0x18, 0x0D,
     0x0D, 0x18, 0x32, 0x21, 0x1C, 0x21, 0x32, 0x32] + [0x32] * 48,
    dtype=np.int32)


def build_huffman_codes(bits: np.ndarray, vals: np.ndarray):
    """Canonical Huffman code assignment (mjpeg.c ff_mjpeg_build_huffman_codes).

    Returns (sizes, codes): arrays of 256 entries indexed by symbol;
    sizes[sym] = code length in bits (0 if unused), codes[sym] = code value.
    """
    sizes = np.zeros(256, dtype=np.int32)
    codes = np.zeros(256, dtype=np.int32)
    code = 0
    k = 0
    for i in range(1, 17):
        for _ in range(int(bits[i])):
            sym = int(vals[k])
            k += 1
            sizes[sym] = i
            codes[sym] = code
            code += 1
        code <<= 1
    return sizes, codes


def build_decode_table(bits: np.ndarray, vals: np.ndarray):
    """Flat 16-bit-peek decode LUT.

    lut_sym[peek16] / lut_len[peek16]: decode result for a 16-bit lookahead.
    Max JPEG code length is 16, so a single 64K-entry table decodes any code
    in one lookup.  len==0 marks an invalid prefix.
    """
    sizes, codes = build_huffman_codes(bits, vals)
    lut_sym = np.zeros(1 << 16, dtype=np.uint8)
    lut_len = np.zeros(1 << 16, dtype=np.uint8)
    for sym in range(256):
        ln = int(sizes[sym])
        if ln == 0:
            continue
        prefix = int(codes[sym]) << (16 - ln)
        span = 1 << (16 - ln)
        lut_sym[prefix:prefix + span] = sym
        lut_len[prefix:prefix + span] = ln
    return lut_sym, lut_len


Q60_LUMA = np.zeros(64, np.int32)
Q60_CHROMA = np.zeros(64, np.int32)
Q60_LUMA[ZIGZAG] = SP5X_QUANT_LUMA_ZZ
Q60_CHROMA[ZIGZAG] = SP5X_QUANT_CHROMA_ZZ
QDC_LUMA = int(SP5X_QUANT_LUMA_ZZ[0])
QDC_CHROMA = int(SP5X_QUANT_CHROMA_ZZ[0])

_HUFF = ((BITS_DC_LUMA, VALS_DC_LUMA), (BITS_DC_CHROMA, VALS_DC_CHROMA),
         (BITS_AC_LUMA, VALS_AC_LUMA), (BITS_AC_CHROMA, VALS_AC_CHROMA))


UNZIGZAG = np.argsort(ZIGZAG).astype(np.int32)   # raster -> scan position


def encoder_quant_matrix(qscale: int) -> np.ndarray:
    """The encoder's quantizer matrix int32 [64], raster order: MPEG-1's
    intra matrix x qscale / 8, clipped to 0..255, DC 8
    (`amv_tpu.codecs.amv_video._encoder_quant_matrix`)."""
    m = np.empty(64, dtype=np.int32)
    m[0] = MPEG1_INTRA_MATRIX[0]
    m[1:] = np.clip((MPEG1_INTRA_MATRIX[1:] * qscale) >> 3, 0, 255)
    return m


def _dht_k3() -> bytes:
    """The payload of a DHT segment with the four K.3 tables (DC luma 0,
    DC chroma 1, AC luma 0, AC chroma 1)."""
    dht = bytearray()
    for tclass, tid, (bits, vals) in zip((0, 0, 1, 1), (0, 1, 0, 1), _HUFF):
        dht.append((tclass << 4) | tid)
        dht += bytes(bits[1:].astype(np.uint8))
        dht += bytes(vals.astype(np.uint8))
    return b"\xFF\xC4" + (len(dht) + 2).to_bytes(2, "big") + bytes(dht)


DHT_K3 = _dht_k3()


def canned_jpeg_header(width: int, height: int) -> bytes:
    """The canonical JPEG header the reference's AMV decoder prepends to
    each frame (sp5xdec.c:50-74): SOI, DQT of the Q60 pair, the K.3 DHT,
    SOF0 of a 4:2:0 picture and SOS."""
    out = bytearray(b"\xFF\xD8\xFF\xDB\x00\x84\x00")
    out += bytes(SP5X_QUANT_LUMA_ZZ.astype(np.uint8)) + b"\x01"
    out += bytes(SP5X_QUANT_CHROMA_ZZ.astype(np.uint8))
    out += DHT_K3
    out += b"\xFF\xC0\x00\x11\x08"
    out += int(height).to_bytes(2, "big") + int(width).to_bytes(2, "big")
    out += b"\x03" + b"\x01\x22\x00" + b"\x02\x11\x01" + b"\x03\x11\x01"
    out += b"\xFF\xDA\x00\x0C\x03" + b"\x01\x00" + b"\x02\x11" + b"\x03\x11"
    out += b"\x00\x3F\x00"
    return bytes(out)


def encoder_qmat(qscale) -> np.ndarray:
    """int32 [64] raster reciprocal quantizer for `qscale` (an int), or a
    ready matrix such as a JAX `qmat_key` (a tuple of 64 ints) as it is."""
    if isinstance(qscale, (tuple, list, np.ndarray)):
        q = np.asarray(qscale, np.int32)
        if q.shape != (64,):
            raise ValueError(f"a quantizer matrix needs 64 entries, got "
                             f"shape {q.shape}")
        return q
    qscale = int(qscale)
    if not 1 <= qscale <= 31:
        raise ValueError(f"qscale must be in 1..31, got {qscale}")
    m = np.empty(64, np.int64)
    m[0] = MPEG1_INTRA_MATRIX[0]
    m[1:] = np.clip((MPEG1_INTRA_MATRIX[1:].astype(np.int64) * qscale) >> 3,
                    0, 255)
    return ((1 << 22) // (8 * m)).astype(np.int32)


def _decode_lut():
    """lut [4, 65536]: lut[t, peek16] = (sym << 5) | len, 0 for an invalid
    prefix: the plain decoder's one-gather table."""
    lut = np.zeros((4, 1 << 16), np.int32)
    for t, (bits, vals) in enumerate(_HUFF):
        syms, lens = build_decode_table(bits, vals)
        lut[t] = np.where(lens > 0, (syms.astype(np.int32) << 5) | lens, 0)
    return lut


def _encode_tables():
    """int32 [2, 4, 256]: [0] code, [1] size (0 for an absent symbol)."""
    out = np.zeros((2, 4, 256), np.int32)
    for t, (bits, vals) in enumerate(_HUFF):
        sizes, codes = build_huffman_codes(bits, vals)
        out[0, t], out[1, t] = codes, sizes
    return out


DEC_LUT = _decode_lut()

# The 8-bit prefixes of each table's codes longer than 8 bits start at
# these values (all ones above): DC-L, DC-C, AC-L, AC-C.
DEC_LONG_PREFIX = (0xFF, 0xFF, 0xFB, 0xFA)


def _decode_fast(lut):
    """int16 blob of a flat table `lut` for kernels D and R: per table t
    the entry (sym << 5) | len of the code that the 16-bit peek p starts
    with, as `lut` has it, in two levels: first[t][p >> 8] for codes of up
    to 8 bits (0 otherwise), then, for the longer codes,
    second[t][((p >> 8) - DEC_LONG_PREFIX[t]) * 256 + (p & 255)], the
    second levels of the four tables one after the other."""
    first = (lut[:, ::256] & 31) <= 8
    first = np.where(first, lut[:, ::256], 0)
    second = []
    for t, lo in enumerate(DEC_LONG_PREFIX):
        long_p = lut[t, lo << 8:]
        assert not first[t, lo:].any() and first[t, :lo].all()
        second.append(long_p)
    out = np.concatenate([first.reshape(-1)] + second)
    assert out.max() < (1 << 15)
    return out.astype(np.int16)


def _record_lut():
    """DEC_LUT as the record decoder reads it (kernel R's plain version):
    an invalid code is length 16 and the table's last symbol, where the
    JAX package's threshold decode clips the length to 16 and the symbol
    index to the table (entropy_async_pallas.py:_token_tables)."""
    last = (11, 11, int(VALS_AC_LUMA[161]), int(VALS_AC_CHROMA[161]))
    return np.stack([np.where(DEC_LUT[t] == 0, (sym << 5) | 16, DEC_LUT[t])
                     for t, sym in enumerate(last)]).astype(np.int32)


RECORD_LUT = _record_lut()
DEC_FAST = _decode_fast(DEC_LUT)
REC_FAST = _decode_fast(RECORD_LUT)
ENC_TABLES = _encode_tables()

_ON_DEVICE: dict = {}


def device_table(name: str, device: torch.device) -> torch.Tensor:
    """The named module-level table as a tensor on `device`, copied there
    once and reused by every later call ("cuda" is the current card's
    copy)."""
    key = (name, device_key(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(
            np.ascontiguousarray(globals()[name])).to(device)
    return _ON_DEVICE[key]

