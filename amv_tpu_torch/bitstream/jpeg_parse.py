"""Baseline JPEG header parser (DQT/DHT/SOF0/SOS) for standard MJPEG.

The port's copy of `amv_tpu/bitstream/jpeg_parse.py`.  The AMV video path
uses canned tables (sp5xdec.c); standard MJPEG frames (MJPEG-in-AVI
input) carry their own tables.  This parser covers the subset the
reference's mjpegdec.c handles for baseline frames.  It reads untrusted
input: a truncated segment raises (struct or numpy), as in the original,
and the scan decoder bounds every read by the scan's length
(`native.decode_scans_custom`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class JpegFrame:
    width: int = 0
    height: int = 0
    # SOF marker byte (0xC0 baseline, 0xC3 lossless) and sample precision
    sof_marker: int = 0xC0
    bits: int = 8
    # lossless SOS fields: Ss = predictor, Al = point transform
    # (mjpegdec.c ff_mjpeg_decode_sos:825-828); baseline scans carry the
    # fixed 0/63/0/0 spectral header
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0
    # Pegasus LJIF APP0 colorspace (mjpegdec.c:962-973): 0 = none,
    # 1 = RGB, 2 = RGB + pegasus reversible color transform
    ljif_colorspace: int = 0
    # AVI1 APP0 field polarity byte (mjpegdec.c:890-914 buggy-AVID
    # marker): 1 = this image is the top field, 2 = bottom field,
    # 0 = absent/unspecified
    avi1_polarity: int = 0
    # quant tables by id, zigzag order
    quant: dict = field(default_factory=dict)
    # huffman specs: (class, id) -> (bits[17], vals[])
    huff: dict = field(default_factory=dict)
    # per component: (id, h, v, quant_id)
    components: list = field(default_factory=list)
    # per scan component: (comp_index, dc_id, ac_id)
    scan_components: list = field(default_factory=list)
    scan: bytes = b""
    # DRI restart interval in MCUs (0 = no restart markers),
    # mjpegdec.c ff_mjpeg_decode_dri
    restart_interval: int = 0

    @property
    def is_420_3c(self):
        if len(self.components) != 3:
            return False
        (h0, v0) = self.components[0][1:3]
        return (h0, v0) == (2, 2) and all(
            c[1] == 1 and c[2] == 1 for c in self.components[1:])

    @property
    def sampling(self):
        """(h_max, v_max) over components."""
        return (max(c[1] for c in self.components),
                max(c[2] for c in self.components))

    def mcu_blocks(self):
        """Interleaved-MCU block list in scan order: one entry
        (comp_index, dc_table_id, ac_table_id, quant_id) per 8x8 block
        (mjpegdec.c mjpeg_decode_scan's nb_blocks/h_count/v_count walk).
        """
        ids = {ci: (dc, ac) for ci, dc, ac in self.scan_components}
        out = []
        for ci, (cid, h, v, tq) in enumerate(self.components):
            dc, ac = ids[ci]
            out.extend([(ci, dc, ac, tq)] * (h * v))
        return out


def parse_jpeg(data: bytes, allow_lossless: bool = False) -> JpegFrame:
    f = JpegFrame()
    if data[0:2] != b"\xFF\xD8":
        raise ValueError("missing SOI")
    pos = 2
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker == 0xD9:
            break
        seglen = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4:pos + 2 + seglen]
        if marker == 0xDB:  # DQT
            b = 0
            while b < len(body):
                pq, tq = body[b] >> 4, body[b] & 0xF
                b += 1
                if pq:
                    tbl = np.frombuffer(body[b:b + 128], ">u2").astype(np.int32)
                    b += 128
                else:
                    tbl = np.frombuffer(body[b:b + 64], np.uint8).astype(np.int32)
                    b += 64
                f.quant[tq] = tbl
        elif marker == 0xC4:  # DHT
            b = 0
            while b < len(body):
                tc, th = body[b] >> 4, body[b] & 0xF
                bits = np.zeros(17, np.int32)
                bits[1:] = np.frombuffer(body[b + 1:b + 17], np.uint8)
                nv = int(bits.sum())
                vals = np.frombuffer(body[b + 17:b + 17 + nv],
                                     np.uint8).astype(np.int32)
                f.huff[(tc, th)] = (bits, vals)
                b += 17 + nv
        elif marker == 0xC0 or (marker == 0xC3 and allow_lossless):
            # SOF0 baseline / SOF3 lossless (mjpegdec.c:1240-1261)
            f.sof_marker = marker
            f.bits = body[0]
            f.height, f.width = struct.unpack_from(">HH", body, 1)
            nc = body[5]
            for c in range(nc):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                f.components.append((cid, hv >> 4, hv & 0xF, tq))
        elif marker in (0xC1, 0xC2, 0xC3):
            raise ValueError(f"unsupported SOF type 0x{marker:02x} "
                             "(baseline only)")
        elif marker == 0xE0 and body[:4] == b"AVI1":
            # buggy-AVID field marker (mjpegdec.c:890-914): byte after
            # the fourcc is the polarity (1 = top field, 2 = bottom)
            if len(body) > 4:
                f.avi1_polarity = body[4]
        elif marker == 0xE0 and body[:4] == b"LJIF":
            # Pegasus lossless header (mjpegdec.c mjpeg_decode_app
            # :962-973): 4x16-bit unknowns then an 8-bit colorspace
            if len(body) >= 13:
                f.ljif_colorspace = body[12]
        elif marker == 0xDD:  # DRI (restart interval in MCUs)
            f.restart_interval = struct.unpack_from(">H", body, 0)[0]
        elif marker == 0xDA:  # SOS
            ns = body[0]
            for c in range(ns):
                cs, tt = body[1 + 2 * c:3 + 2 * c]
                idx = next(i for i, comp in enumerate(f.components)
                           if comp[0] == cs)
                f.scan_components.append((idx, tt >> 4, tt & 0xF))
            f.ss, f.se = body[1 + 2 * ns], body[2 + 2 * ns]
            f.ah, f.al = body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 0xF
            f.scan = data[pos + 2 + seglen:]
            # strip trailing EOI if present
            eoi = f.scan.rfind(b"\xFF\xD9")
            if eoi != -1:
                f.scan = f.scan[:eoi]
            return f
        pos += 2 + seglen
    raise ValueError("no SOS found")
