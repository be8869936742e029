"""AMV video tables: the state the transcode carries besides the data.

The codec has no weights; its parameters are fixed tables, derived here
once as numpy arrays from `amv_tpu.bitstream.jpeg_tables` (the shared,
framework-free host layer).  The kernel wrappers copy them to a device
once per device (`device_table`).

* `encoder_qmat(qscale)`: the encoder's reciprocal quantizer matrix
  (mpegvideo_enc.c ff_convert_matrix over the MPEG-1 intra matrix), raster
  order; the counterpart of `amv_tpu.codecs.amv_video._encoder_quant_qmat_np`.
* `Q60_LUMA` / `Q60_CHROMA`: the decoder's sp5x Q60 dequant tables, raster.
* Huffman tables (JPEG K.3), indexed DC-luma 0, DC-chroma 1, AC-luma 2,
  AC-chroma 3: `DEC_LUT` (flat 16-bit-peek table for the plain decoder),
  `DEC_TABLES` (two-level form for the decode kernel), `ENC_TABLES`
  (code and size per symbol).
"""

from __future__ import annotations

import numpy as np
import torch

from amv_tpu.bitstream import jpeg_tables as T

ZIGZAG = T.ZIGZAG.astype(np.int64)

Q60_LUMA = np.zeros(64, np.int32)
Q60_CHROMA = np.zeros(64, np.int32)
Q60_LUMA[T.ZIGZAG] = T.SP5X_QUANT_LUMA_ZZ
Q60_CHROMA[T.ZIGZAG] = T.SP5X_QUANT_CHROMA_ZZ
QDC_LUMA = int(T.SP5X_QUANT_LUMA_ZZ[0])
QDC_CHROMA = int(T.SP5X_QUANT_CHROMA_ZZ[0])

_HUFF = ((T.BITS_DC_LUMA, T.VALS_DC_LUMA), (T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
         (T.BITS_AC_LUMA, T.VALS_AC_LUMA), (T.BITS_AC_CHROMA, T.VALS_AC_CHROMA))


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
    m[0] = T.MPEG1_INTRA_MATRIX[0]
    m[1:] = np.clip((T.MPEG1_INTRA_MATRIX[1:].astype(np.int64) * qscale) >> 3,
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
        syms, lens = T.build_decode_table(bits, vals)
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
        sizes, codes = T.build_huffman_codes(bits, vals)
        out[0, t], out[1, t] = codes, sizes
    return out


DEC_LUT, DEC_TABLES = _decode_tables()
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

