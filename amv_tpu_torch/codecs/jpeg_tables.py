"""Fixed JPEG tables of the AMV (Sunplus sp5x) MJPEG variant.

The port's own copy of what it reads from `amv_tpu/bitstream/jpeg_tables.py`:

* zigzag scan order (libavcodec dsputil.c ff_zigzag_direct);
* the sp5x "Q60" quant pair the decoder uses (sp5x.h:187-195, index 5),
  zigzag order;
* the standard JPEG K.3 Huffman tables (mjpeg.c:65-126);
* the MPEG-1 default intra matrix, the basis of the encoder's quantizer
  (mpeg12data.c, applied at mpegvideo_enc.c:2866-2876);
* canonical code assignment and the flat 16-bit-peek decode table;

and the forms derived from them once, as numpy arrays, that the kernels
read (the wrappers copy them to a device once per device, `device_table`):

* `encoder_qmat(qscale)`: the encoder's reciprocal quantizer matrix
  (mpegvideo_enc.c ff_convert_matrix over the MPEG-1 intra matrix), raster
  order; the counterpart of `amv_tpu.codecs.amv_video._encoder_quant_qmat_np`;
* `Q60_LUMA` / `Q60_CHROMA`: the decoder's sp5x Q60 dequant tables, raster;
* Huffman tables, indexed DC-luma 0, DC-chroma 1, AC-luma 2, AC-chroma 3:
  `DEC_LUT` (flat 16-bit-peek table for the plain decoder), `DEC_TABLES`
  (two-level form for the record decode kernel), `DEC_FAST` (kernel D's
  two-level form), `ENC_TABLES` (code and size per
  symbol).
"""

from __future__ import annotations

import numpy as np
import torch

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


def _decode_tables():
    """(lut [4, 65536], blob) for the decoders.

    lut[t, peek16] = (sym << 5) | len, 0 for an invalid prefix: the
    plain decoder's one-gather table.  blob is the kernel's two-level
    form, per table t: e1[256] (the same entry for codes of <= 8 bits,
    else 0; entropy.c build_tables_one), maxcode[17] and valoff[17]
    (canonical decode, JPEG F.16: the longest codes resolve as
    vals[valoff[L] + code] where code <= maxcode[L]) and vals[256].
    """
    lut = np.zeros((4, 1 << 16), np.int32)
    blob = np.zeros((4, 256 + 17 + 17 + 256), np.int32)
    for t, (bits, vals) in enumerate(_HUFF):
        syms, lens = build_decode_table(bits, vals)
        lut[t] = np.where(lens > 0, (syms.astype(np.int32) << 5) | lens, 0)
        e1 = lut[t, ::256]
        blob[t, :256] = np.where((e1 & 31) <= 8, e1, 0)
        maxcode = np.full(17, -1, np.int32)
        valoff = np.zeros(17, np.int32)
        code = k = 0
        for L in range(1, 17):
            n = int(bits[L])
            if n:
                valoff[L] = k - code
                maxcode[L] = code + n - 1
            code = (code + n) << 1
            k += n
        blob[t, 256:273] = maxcode
        blob[t, 273:290] = valoff
        blob[t, 290:290 + len(vals)] = vals
    return lut, blob.reshape(-1)


def _encode_tables():
    """int32 [2, 4, 256]: [0] code, [1] size (0 for an absent symbol)."""
    out = np.zeros((2, 4, 256), np.int32)
    for t, (bits, vals) in enumerate(_HUFF):
        sizes, codes = build_huffman_codes(bits, vals)
        out[0, t], out[1, t] = codes, sizes
    return out


DEC_LUT, DEC_TABLES = _decode_tables()

# The 8-bit prefixes of each table's codes longer than 8 bits start at
# these values (all ones above): DC-L, DC-C, AC-L, AC-C.
DEC_LONG_PREFIX = (0xFF, 0xFF, 0xFB, 0xFA)


def _decode_fast():
    """int16 blob for kernel D: per table t the entry (sym << 5) | len of
    the code that the 16-bit peek p starts with, 0 for an invalid code, in
    two levels: first[t][p >> 8] for codes of up to 8 bits (0 otherwise),
    then, for the longer codes, second[t][((p >> 8) - DEC_LONG_PREFIX[t]) *
    256 + (p & 255)], the second levels of the four tables one after the
    other."""
    first = (DEC_LUT[:, ::256] & 31) <= 8
    first = np.where(first, DEC_LUT[:, ::256], 0)
    second = []
    for t, lo in enumerate(DEC_LONG_PREFIX):
        long_p = DEC_LUT[t, lo << 8:]
        assert not first[t, lo:].any() and first[t, :lo].all()
        second.append(long_p)
    out = np.concatenate([first.reshape(-1)] + second)
    assert out.max() < (1 << 15)
    return out.astype(np.int16)


DEC_FAST = _decode_fast()


def _record_lut():
    """DEC_LUT as the record decoder reads it (kernel R's plain version):
    an invalid code is length 16 and the table's last symbol, where the
    JAX package's threshold decode clips the length to 16 and the symbol
    index to the table (entropy_async_pallas.py:_token_tables)."""
    last = (11, 11, int(VALS_AC_LUMA[161]), int(VALS_AC_CHROMA[161]))
    return np.stack([np.where(DEC_LUT[t] == 0, (sym << 5) | 16, DEC_LUT[t])
                     for t, sym in enumerate(last)]).astype(np.int32)


RECORD_LUT = _record_lut()
ENC_TABLES = _encode_tables()

_ON_DEVICE: dict = {}


def device_table(name: str, device: torch.device) -> torch.Tensor:
    """The named module-level table as a tensor on `device`, copied there
    once and reused by every later call."""
    key = (name, str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(
            np.ascontiguousarray(globals()[name])).to(device)
    return _ON_DEVICE[key]

